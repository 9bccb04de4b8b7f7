"""The training step's share (%) of the card's float32 peak (the program
turns TF32 off): three times the family's forward FLOPs of an image
(forward, and the two products of the backward) times the images
consumed over the whole window of the traced run."""

from benchmark.harness.readers import mfu


def read(obs):
    flops = 3 * obs.family.train_image_flops(obs.config)
    return mfu(obs, flops, obs.window["images"], "fp32_flops")
