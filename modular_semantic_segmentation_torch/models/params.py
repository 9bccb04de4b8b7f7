"""npz weight IO: the same file contract as the JAX package's
``models/params.py``.

Keys are TF variable names (``rgb/conv1_1/kernel``); conv kernels are HWIO
``[kh, kw, in, out]``, transposed-conv kernels ``[kh, kw, out, in]``, and BN
keeps ``gamma/beta/moving_mean/moving_variance``. The port's variable store
uses the same names and layouts, so files written by either package load
into the other.
"""

import re
from os import path

import numpy as np
import torch


def export_weights(variables, output_dir, name, step=0):
    """Write variables to ``<output_dir>/<name>_weights_<step>.npz``."""
    output_path = path.join(output_dir, f"{name}_weights_{step}.npz")
    np.savez_compressed(output_path, **{
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)) for k, v in variables.items()})
    print(f"INFO: Weights saved to {output_path}")
    return output_path


def _detect_import_prefix(keys):
    """First key's leading scope, before '/' and before '_'."""
    scoped = sorted(k for k in keys if "/" in k)
    first = scoped[0] if scoped else sorted(keys)[0]
    return first.split("/")[0].split("_")[0]


def translate_name(name, target_prefix, import_prefix):
    """Translate ``target_prefix``-scoped names to the imported file's
    prefix."""
    if not name.startswith(target_prefix):
        return name
    parts = name.split("/")
    sub = parts[0].split("_")
    if sub[0] == "forest":  # reference quirk: forest prefix is never touched
        return name
    sub[0] = import_prefix
    parts[0] = "_".join(sub)
    return "/".join(parts)


_OPTIMIZER_PAT = re.compile(r"grad|Adam|RMS")


def import_weights(variables, filepath, translate_prefix=False,
                   chill_mode=False, warnings=True):
    """Assign matching arrays from an npz file into a variable store.

    Returns a NEW dict and a report ``{"missing": [...], "mismatched":
    [...]}``. The rules are the JAX package's: optimizer slots are skipped;
    a name also matches with its first '/' replaced by '_'; shape
    mismatches are skipped with a warning (``chill_mode`` only changes the
    warning text). Imported tensors land on the device of the variable
    they replace, as float32.
    """
    if warnings:
        print(filepath)
    with np.load(filepath) as archive:
        weights = {k: archive[k] for k in archive.files}
    import_prefix = _detect_import_prefix(weights.keys())

    out = dict(variables)
    missing, mismatched = [], []
    for name, current in variables.items():
        lookup = (translate_name(name, translate_prefix, import_prefix)
                  if translate_prefix else name)
        if _OPTIMIZER_PAT.search(lookup):
            continue
        if lookup not in weights and lookup.replace("/", "_", 1) in weights:
            lookup = lookup.replace("/", "_", 1)
        if lookup not in weights:
            if name == "global_step":
                continue
            missing.append(name)
            if warnings:
                print(f"WARNING: {lookup} not found in saved weights")
            continue
        value = weights[lookup]
        if tuple(value.shape) != tuple(current.shape):
            mismatched.append(name)
            if warnings:
                print(f"WARNING: wrong shape found for {lookup}, skipped"
                      f"{' (chill mode)' if chill_mode else ''}")
                print("stored shape:", value.shape,
                      "expected shape:", tuple(current.shape))
            continue
        out[name] = torch.from_numpy(
            np.asarray(value, np.float32)).to(current.device)
    return out, {"missing": missing, "mismatched": mismatched}


def from_jax_variables(np_dict, device="cuda"):
    """The JAX package's parameters (a ``{tf_name: array}`` dict, as numpy)
    as a port variable store on ``device`` (the card by default, as for
    every entry point of the port; pass ``device="cpu"`` for the CPU).

    Both packages use TF names and the npz layouts, so this is a
    name-for-name copy into float32 tensors.
    """
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in np_dict.items()}
