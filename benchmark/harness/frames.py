"""Seeded frames, made on the device in a few calls and kept in host memory,
as a camera or a data loader would hand them over.

Served frames: rgb half 32x32 blocks of one colour and half texture
(each pixel's own uniform draw), over [0, 255); depth uniform in [0, 1).
Pixel-level variation of the full range keeps bf16's rounding of the raw
frame (up to 0.5) small beside the content, as in a camera's frames.
Training frames: rgb of 32x32 blocks in [0, 247] plus noise in [0, 8),
and labels that are a function of the input an FCN can learn, the red
channel of each block quantized to the classes, with a void (-1)
border.
"""

import torch

BLOCK = 32
BORDER = 16


def _blocks(gen, count, height, width, device):
    """[count, H, W, 3] of 32x32 blocks of one value each, in [0, 1)."""
    bh, bw = -(-height // BLOCK), -(-width // BLOCK)
    values = torch.rand((count, bh, bw, 3), generator=gen, device=device)
    full = values.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2)
    return full[:, :height, :width]


def _rgb(gen, full, device, texture):
    """``full`` blocks times (255 - texture) plus a uniform draw in
    [0, texture) at each pixel."""
    noise = torch.rand(full.shape, generator=gen, device=device)
    return full * (255.0 - texture) + noise * texture


def serving_pool(modalities, count, height, width, seed, device):
    """``[{modality: float32 numpy [H, W, C]}] * count``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    arrays = {}
    for modality, channels in modalities.items():
        if channels == 3:
            full = _blocks(gen, count, height, width, device)
            value = _rgb(gen, full, device, texture=127.5)
        else:
            value = torch.rand((count, height, width, channels),
                               generator=gen, device=device)
        arrays[modality] = value.float().cpu().numpy()
    return [{m: a[i] for m, a in arrays.items()} for i in range(count)]


def learnable_frames(count, height, width, num_classes, seed, device):
    """``{"rgb": float32 [N, H, W, 3], "labels": int32 [N, H, W]}`` numpy,
    from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    full = _blocks(gen, count, height, width, device)
    rgb = _rgb(gen, full, device, texture=8.0)
    labels = torch.clamp((full[..., 0] * num_classes).long(),
                         max=num_classes - 1).int()
    labels[:, :BORDER] = -1
    labels[:, -BORDER:] = -1
    labels[:, :, :BORDER] = -1
    labels[:, :, -BORDER:] = -1
    return {"rgb": rgb.float().cpu().numpy(),
            "labels": labels.cpu().numpy()}
