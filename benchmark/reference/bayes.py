"""Bayes fusion of expert labels (Blum et al., IROS 2018, eq. 2), in float64.

Each expert e says a label k_e at a pixel. With the expert's confusion
matrix M_e on the measure set (rows the true class c, columns the label
said), p(k | c) = M_e[c, k] / sum_k' M_e[c, k'], and the fused class is

    argmax_c  sum_e log(1e-20 + p(k_e | c)) + log p(c),

the prior p(c) being the true-class frequency of the last expert's matrix.
As the fused class depends on the experts' labels alone, it is a table
over every combination of labels.
"""

import numpy as np


def fused_scores(confusion_matrices):
    """The fused log-scores ``[K] * E + [K]`` of every combination of
    expert labels, float64."""
    mats = [np.asarray(m, np.float64) for m in confusion_matrices]
    num_classes = mats[0].shape[0]
    num_experts = len(mats)
    total = np.zeros([num_classes] * num_experts + [num_classes])
    for e, m in enumerate(mats):
        with np.errstate(divide="ignore", invalid="ignore"):
            said_given_true = np.nan_to_num(m / m.sum(1, keepdims=True))
        shape = [1] * num_experts + [num_classes]
        shape[e] = num_classes
        # [k_e, c]: log p(k_e | c)
        total = total + np.log(1e-20 + said_given_true.T).reshape(shape)
    prior = mats[-1].sum(1) / mats[-1].sum()
    return total + np.log(prior)


def decision_table(confusion_matrices):
    """The fused class of every combination of expert labels, int64."""
    return np.argmax(fused_scores(confusion_matrices), axis=-1)


def decision_margin(confusion_matrices):
    """The least gap between the best and second-best fused score over all
    combinations: how far the table is from a tie."""
    top2 = np.sort(fused_scores(confusion_matrices), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))
