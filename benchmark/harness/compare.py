"""The numbers that decide ``correct``.

Served labels. A fused label is the fusion table's entry for the experts'
labels, so it is judged by the experts' class scores in the reference:
the label is sound where some combination of expert labels that the table
maps to it lies close to each expert's best score. Per pixel,

    gap = min over (k_1, ..., k_E) with table[k] = label of
          max_e (max_j s_e[j] - s_e[k_e]) / sd(s_e),

``s_e`` the reference's float32 scores of expert e and ``sd(s_e)`` their
standard deviation over the frame, so the gap is in units of the scores'
spread. A label that no combination gives reads ``UNSUPPORTED``.

* ``label_gap``: the widest gap over every pixel of the sampled frames;
* ``label_mismatch``: the share of those pixels whose label differs from
  the reference's own fused label.

Served experts. Each expert's class probabilities of the sampled frames,
as the program's serving path gives them, against the reference's
float32 scores, by the margins they imply: for every class k within
``MARGIN_SPAN`` of the reference's best class t at a pixel,

    d = (log p_k - log p_t) - (s_k - s_t),

the program's log-ratio less the reference's score margin, in units of
the root mean square of the reference's scores ``rms(s)`` over the frame:
rounding errs in proportion to the magnitude of what it rounds.

* ``score_off_share``: the share of those margins, over both experts and
  every sampled frame, with ``|d|`` above ``SCORE_TOL``. Rounding spreads
  d over a width that the precision sets, so the share of a tail well
  beyond bf16's width stays near nought in bf16 and rises steeply as the
  precision falls.

Training steps (of one model object, against the reference's steps from
the same weights on the same batches): for leaves that the reference
moves, the gap between the program's norm and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf.

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap of the first gradient's norm;
* ``change_gap``: the worst leaf's gap of the norm of the parameters'
  change after the checked steps.

A leaf whose first gradient in the reference is under a thousandth of the
median leaf's (a conv's bias under batch norm, nought but rounding) is
left out of both.
"""

import torch

UNSUPPORTED = 1.0e6
PIXEL_CHUNK = 1 << 16
# margins counted in score_off_share: classes whose reference probability
# is at least e**-12 of the best class's (6e-6), well inside bf16's range
MARGIN_SPAN = 12.0
# the tail of score_off_share, in units of rms(s): 3.3 to 9 times the root
# mean square of d in bf16 (0.009-0.024 on an H100), 1.2 to 1.8 times the
# int8 path's (0.043-0.069)
SCORE_TOL = 0.08


def label_readings(label, scores, table):
    """(widest gap, mismatched pixels, pixels) of one frame.

    ``label``: [H, W] int served labels; ``scores``: per expert [K, H, W]
    float reference scores; ``table``: [K] * E int fused decisions, all
    on one device."""
    num_classes = scores[0].shape[0]
    label = label.reshape(-1).long()
    flat = [s.reshape(num_classes, -1).float() for s in scores]
    gaps = [(s.amax(0, keepdim=True) - s) / s.std() for s in flat]
    experts = len(flat)
    table = table.long()
    ref_label = table[tuple(s.argmax(0) for s in flat)]
    widest = 0.0
    for lo in range(0, label.numel(), PIXEL_CHUNK):
        hi = min(lo + PIXEL_CHUNK, label.numel())
        worst = None
        for e, g in enumerate(gaps):
            shape = [1] * experts + [hi - lo]
            shape[e] = num_classes
            part = g[:, lo:hi].reshape(shape)
            worst = part if worst is None else torch.maximum(worst, part)
        hit = table.unsqueeze(-1) == label[lo:hi]
        gap = torch.where(hit, worst, torch.full_like(worst, UNSUPPORTED))
        gap = gap.reshape(-1, hi - lo).amin(0)
        widest = max(widest, float(gap.max()))
    mismatched = int((ref_label != label).sum())
    return widest, mismatched, label.numel()


def expert_readings(prob, scores):
    """(margins off by more than ``SCORE_TOL``, margins counted) of one
    expert on one frame: ``prob`` [H, W, K] the program's probabilities,
    ``scores`` [K, H, W] the reference's, on one device."""
    num_classes = scores.shape[0]
    s = scores.reshape(num_classes, -1).float()
    p = prob.reshape(-1, num_classes).t().float()
    top = s.argmax(0, keepdim=True)
    margin = s - s.gather(0, top)
    log_p = torch.log(p.clamp_min(1e-38))
    d = (log_p - log_p.gather(0, top)) - margin
    counted = (margin >= -MARGIN_SPAN) & (margin < 0)
    off = counted & (d.abs() > SCORE_TOL * s.pow(2).mean().sqrt())
    return int(off.sum()), int(counted.sum())


def norms(tensors):
    """{name: float64 norm} of a dict of tensors."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _median(values):
    values = sorted(values)
    n = len(values)
    return 0.5 * (values[(n - 1) // 2] + values[n // 2])


def worst_leaf_gap(program, reference, leaves):
    """Worst leaf of |norm_p - norm_r| / max(norm_r, median norm_r)."""
    med = _median([reference[k] for k in leaves])
    return max(abs(program[k] - reference[k]) / max(reference[k], med)
               for k in leaves)


def training_readings(program, reference):
    """``{loss_gap, grad_gap, change_gap}`` and the leaves counted.

    ``program`` and ``reference``: dicts with ``losses`` [floats],
    ``grad_norms`` and ``change_norms`` {leaf: float}."""
    ref_grads = reference["grad_norms"]
    floor = 1e-3 * _median(list(ref_grads.values()))
    leaves = sorted(k for k, v in ref_grads.items() if v >= floor)
    loss_gap = (max(abs(p - r) / abs(r) for p, r in
                    zip(program["losses"], reference["losses"]))
                if len(program["losses"]) == len(reference["losses"])
                else UNSUPPORTED)
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(program["grad_norms"], ref_grads,
                                       leaves),
            "change_gap": worst_leaf_gap(program["change_norms"],
                                         reference["change_norms"], leaves),
            }, leaves
