"""The fused model step's share (%) of the card's bf16 peak: the family's
FLOPs of one fused frame (both experts and the fusion) times the frames
delivered over the whole window of the traced run."""

from benchmark.harness.readers import mfu


def read(obs):
    flops = obs.family.fused_frame_flops(obs.config)
    return mfu(obs, flops, obs.window["units"], "bf16_flops")
