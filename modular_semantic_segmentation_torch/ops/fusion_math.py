"""Statistical fusion math (counterpart of the JAX package's
``ops/fusion_math.py``).

    * Bayes: fused log-score = sum_e log p(expert output | true class) +
      log prior, the likelihood being the column-normalized (transposed)
      confusion matrix; plus the K^E decision-matrix lookup.
    * Dirichlet: per (expert, class) a Dirichlet over the expert's softmax
      simplex; the per-pixel log-likelihood is a [pixels, K] @ [K, C]
      contraction. ``dirichlet_fusion`` is the plain form; the fused label
      in one pass is the kernel of ``ops/cuda/dirichlet.py``. Its fit
      starts from ``dirichlet_sufficient_statistics``;
    * Dirichlet with per-pixel uncertainty: the concentrations blended
      toward the uninformative I + 1 (``dirichlet_uncertainty_fusion``);
    * variance: inverse-variance weighting of MC-dropout experts.

Host-side statistics (priors, conditionals, decision tables) are numpy in
float64, as in the JAX package; per-pixel work is PyTorch on the device
of the classifications.
"""

import numpy as np
import torch

# The reference hardcodes a uniform prior of 1/14 (14 synthia classes)
# regardless of the actual class count; kept for metric parity.
REFERENCE_UNIFORM_PRIOR = 1.0 / 14


def class_prior(spec, data_prior, uniform_value=REFERENCE_UNIFORM_PRIOR):
    """Resolve a prior spec into a prior vector.

    spec: 'data' | 'uniform' | float x -> x * uniform + (1-x) * data,
    renormalized.
    """
    data_prior = np.asarray(data_prior, np.float64)
    if isinstance(spec, str):
        if spec == "uniform":
            return np.full_like(data_prior, uniform_value)
        if spec == "data":
            return data_prior
        raise ValueError(f"unknown class prior '{spec}'")
    weight = float(spec)
    prior = weight * uniform_value + (1 - weight) * data_prior
    return prior / prior.sum()


def confusion_to_conditional(confusion_matrix):
    """p(expert output | true class): column-normalize, NaNs -> 0.

    The caller feeds the TRANSPOSED confusion matrix, as the reference
    model does (``BayesFusion`` transposes on construction)."""
    cm = np.asarray(confusion_matrix, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cond = np.nan_to_num(cm / cm.sum(0))
    return cond


def _data_prior_from_cm(confusion_matrix):
    cm = np.asarray(confusion_matrix, np.float64)
    return cm.sum(0) / cm.sum()


def bayes_tables(confusion_matrices, class_prior_spec="data", device="cpu"):
    """The per-expert tables of :func:`bayes_fusion`, on ``device``.

    Returns (conditionals [E, K, K], log-conditionals [E, K, K], log prior
    [K]), float32. The log-conditionals are taken in float64 on the host
    and the log prior in float32 on the device, as in the JAX package.
    """
    conds = np.stack([confusion_to_conditional(cm)
                      for cm in confusion_matrices])
    prior = class_prior(class_prior_spec,
                        _data_prior_from_cm(confusion_matrices[-1]))
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(device)
    return to(conds), to(np.log(1e-20 + conds)), torch.log(to(prior))


def bayes_fusion_from_tables(classifications, tables):
    """:func:`bayes_fusion` with the tables of :func:`bayes_tables`."""
    conds, log_conds, log_prior = tables
    # a row gather: the same values as the JAX package's one-hot
    # contraction, whose 0/1 selectors are exact
    conditionals = [conds[e][cls] for e, cls in enumerate(classifications)]
    log_likelihoods = [log_conds[e][cls]
                       for e, cls in enumerate(classifications)]
    fused = torch.stack(log_likelihoods, dim=0).sum(dim=0) + log_prior
    return fused, log_likelihoods, conditionals


def bayes_fusion(classifications, confusion_matrices, class_prior_spec="data"):
    """Bayes fusion of hard expert classifications.

    Args:
        classifications: list (per expert) of int tensors [...].
        confusion_matrices: list of [K, K] arrays (transposed convention,
            see :func:`confusion_to_conditional`).
        class_prior_spec: 'data' | 'uniform' | float.
    Returns:
        (fused_score [..., K], log_likelihoods list, conditionals list)
    """
    tables = bayes_tables(confusion_matrices, class_prior_spec,
                          device=classifications[0].device)
    return bayes_fusion_from_tables(classifications, tables)


def bayes_decision_matrix(confusion_matrices, class_prior_spec="data"):
    """The fused decision for all K^E expert-output combinations, as a
    host-side [K] * E int32 lookup table."""
    num_classes = confusion_matrices[0].shape[0]
    num_experts = len(confusion_matrices)
    conds = [confusion_to_conditional(cm) for cm in confusion_matrices]

    total = np.zeros([num_classes] * num_experts + [num_classes], np.float64)
    for e, cond in enumerate(conds):
        shape = [1] * num_experts + [num_classes]
        shape[e] = num_classes
        total = total + np.log(1e-20 + cond).reshape(shape)

    prior = class_prior(class_prior_spec,
                        _data_prior_from_cm(confusion_matrices[-1]))
    total = total + np.log(prior)
    return np.argmax(total, axis=-1).astype(np.int32)


def apply_decision_matrix(decision_matrix, classifications):
    """Fused classification by lookup: table[c_1, ..., c_E] per pixel."""
    table = torch.as_tensor(decision_matrix,
                            device=classifications[0].device)
    num_classes = table.shape[0]
    idx = classifications[0].long()
    for cls in classifications[1:]:
        idx = idx * num_classes + cls
    return table.reshape(-1)[idx].to(torch.int32)


def dirichlet_log_likelihoods(probs, alphas, sigma=1.0):
    """Per-pixel log Dir(p; sigma * alpha_c) for every conditioning class c.

    Args:
        probs: [..., K] expert softmax probabilities.
        alphas: [K, C] concentrations; column c is the Dirichlet over the
            K-simplex conditional on true class c.
        sigma: temperature scaling of the concentrations.
    Returns:
        [..., C] float32 log-likelihood per conditioning class.
    """
    alphas = torch.as_tensor(np.asarray(alphas, np.float32),
                             device=probs.device) * sigma
    log_p = torch.log(1e-20 + probs.float())
    # log B(a) = sum_k lgamma(a_k) - lgamma(sum_k a_k), per column
    log_beta = (torch.lgamma(alphas).sum(0)
                - torch.lgamma(alphas.sum(0)))
    return log_p @ (alphas - 1.0) - log_beta


def dirichlet_fusion(probs, alphas, prior, sigma=1.0):
    """Fused Dirichlet log-score [..., C] (plain PyTorch).

    Args:
        probs: list (per expert) of [..., K] probabilities.
        alphas: list (per expert) of [K, C] concentration matrices.
        prior: [C] class prior.
    """
    lls = [dirichlet_log_likelihoods(p, a, sigma)
           for p, a in zip(probs, alphas)]
    fused = torch.stack(lls, dim=0).sum(dim=0)
    prior = torch.as_tensor(np.asarray(prior, np.float32),
                            device=fused.device)
    return fused + torch.log(1e-20 + prior)


def dirichlet_uncertainty_fusion(probs, alphas, uncertainties, prior,
                                 sigma=1.0):
    """Dirichlet fusion with per-pixel uncertainty blending toward an
    uninformative Dirichlet (reference uncertainty_dirichlet_mix.py:18-52).

    Args:
        probs: list (per expert) of [..., K] probabilities.
        alphas: list (per expert) of [K, C] concentration matrices.
        uncertainties: list (per expert) of [...] in [0, 1]; 1 = fully
            uncertain -> parameters blended to the uninformative I + 1.
        prior: [C] class prior.
    Returns:
        fused score [..., C], float32.
    """
    num_classes = probs[0].shape[-1]
    device = probs[0].device
    uninformative = torch.eye(num_classes, dtype=torch.float32,
                              device=device) + 1.0
    lls = []
    for p, a, mix in zip(probs, alphas, uncertainties):
        a = torch.as_tensor(np.asarray(a, np.float32), device=device) * sigma
        u = uninformative * sigma
        m = torch.clamp(mix.float(), 0.0, 1.0)[..., None]  # [..., 1]
        log_p = torch.log(1e-20 + p.float())
        # The per-pixel concentration is alpha_px = (1-m)*a + m*u, shape
        # [..., K, C], and the log-pdf is sum_k (alpha_px_k - 1) log p_k
        # - log B(alpha_px). The linear term is linear in alpha_px, so it
        # splits into two matmuls blended per pixel, as the JAX package
        # splits it; only the normalizer log B(alpha_px) needs the
        # per-pixel gammaln.
        linear = ((1.0 - m) * (log_p @ a) + m * (log_p @ u)
                  - torch.sum(log_p, dim=-1, keepdim=True))
        alpha_px = (1.0 - m[..., None]) * a + m[..., None] * u
        log_beta = (torch.special.gammaln(alpha_px).sum(-2)
                    - torch.special.gammaln((1.0 - m) * a.sum(0)
                                            + m * u.sum(0)))
        lls.append(linear - log_beta)
    fused = torch.stack(lls, dim=0).sum(dim=0)
    prior = torch.as_tensor(np.asarray(prior, np.float32), device=device)
    return fused + torch.log(1e-20 + prior)


def variance_fusion(probs, variances):
    """Inverse-variance weighting (reference variance_mix.py:7-15).

    Args:
        probs: [E, ..., K] stacked expert probabilities.
        variances: [E, ..., 1] per-pixel MC-dropout variances.
    """
    certainties = 1.0 / (1e-20 + variances)
    return (torch.sum(certainties * probs, dim=0)
            / torch.sum(certainties, dim=0))


def dirichlet_sufficient_statistics(probs, labels, num_classes, eps=1e-10):
    """Per-true-class sums of log expert probabilities, on the device of
    ``probs``.

    For class c: ss[c, k] = sum over pixels with label c of log(eps + p_k).
    Pixels whose label is < 0 or >= C count nowhere, as in the JAX
    package's one-hot contraction, whose one-hot row is zero for them;
    here they are summed into a dropped row C by ``index_add_``.

    Args:
        probs: [..., K] expert probabilities.
        labels: [...] integer labels.
    Returns:
        (ss [C, K] float32, class_counts [C] float32)
    """
    k = probs.shape[-1]
    log_p = torch.log(eps + probs.reshape(-1, k).float())
    flat_l = labels.reshape(-1).long().to(log_p.device)
    index = torch.where((flat_l >= 0) & (flat_l < num_classes), flat_l,
                        num_classes)
    ss = torch.zeros((num_classes + 1, k), dtype=torch.float32,
                     device=log_p.device).index_add_(0, index, log_p)
    counts = torch.zeros(num_classes + 1, dtype=torch.float32,
                         device=log_p.device).index_add_(
        0, index, torch.ones_like(index, dtype=torch.float32))
    return ss[:num_classes], counts[:num_classes]
