"""Host-side Dirichlet maximum-a-posteriori estimation (the port's own
copy of the JAX package's ``ops/dirichlet_estimation.py``, which is
NumPy/SciPy only but lives in a package that imports JAX).

Fits per-class Dirichlet concentration parameters from sufficient statistics
(mean log expert probabilities). This is the EM tail of the Dirichlet fusion
fit: a tiny K-dimensional problem solved on the host in float64 while the
device handles the statistic reduction.

The estimator replicates the algorithm the reference actually uses
(xview/models/dirichletDifferentiation.py:129-192, a penalized variant of
Max Sklar's / Minka's Newton solver): objective

    L(a) = (1-beta) * [gammaln(sum a) - sum gammaln(a)] + <a, ss>
           - delta * |a|^2 - beta * <a, neg_ss>

maximized by (1) a Newton step using the structured Hessian
(diag + rank-one, Minka eq. 18), (2) a log-space Newton step fallback, and
(3) gradient ascent with learning-rate backoff, in that order per
iteration, with the same tolerances, so fitted parameters match the
reference's.

Also provides Minka fixed-point / mean-precision alternatives
(reference xview/models/dirichlet_fastfit.py) kept callable for the same
configs the reference exposes (dirichlet_mix.py:6-9).
"""

import numpy as np
from scipy import special

GRADIENT_TOL_SQ = 2.0 ** -20
LEARN_RATE_TOL = 2.0 ** -10


def _objective(alphas, ss, neg_ss, beta, delta):
    a_sum = alphas.sum()
    val = (1 - beta) * special.gammaln(a_sum)
    val -= (1 - beta) * special.gammaln(alphas).sum()
    val += float(np.dot(alphas, ss))
    val -= delta * float(np.square(alphas).sum())
    val -= beta * float(np.dot(alphas, neg_ss))
    return val


def _gradient(alphas, ss, neg_ss, beta, delta):
    return ((1 - beta) * special.psi(alphas.sum())
            + ss
            - (1 - beta) * special.psi(alphas)
            - 2 * delta * alphas
            - beta * neg_ss)


def _loss(alphas, ss, neg_ss, beta, delta):
    if np.any(alphas <= 0):
        return np.inf
    return -_objective(alphas, ss, neg_ss, beta, delta)


def _newton_step(alphas, gradient, beta):
    """Minka eq. 18 step for the diag + rank-one Hessian."""
    h_const = -(1 - beta) * special.polygamma(1, alphas.sum())
    h_diag = (1 - beta) * special.polygamma(1, alphas)
    b = (gradient / h_diag).sum() / (1.0 / h_const + (1.0 / h_diag).sum())
    return (b - gradient) / h_diag


def _log_space_step(alphas, gradient, beta):
    """Newton step on log-alpha (diagonal Hessian in log space)."""
    h_const = -(1 - beta) * special.polygamma(1, alphas.sum())
    h_diag = (1 - beta) * special.polygamma(1, alphas)
    denom = gradient - alphas * h_diag
    z = h_const * (alphas / denom).sum()
    s = ((1.0 / denom) / (1 + z)).sum()
    return gradient / denom * (1 - h_const * alphas * s)


def find_dirichlet_priors(ss, neg_ss, init_alphas, max_iter=1000, delta=1e-2,
                          beta=1e-2, verbose=False):
    """Penalized Dirichlet MAP from sufficient statistics.

    Args:
        ss: [K] mean log probabilities of the positive class examples.
        neg_ss: [K] mean log probabilities of the negative examples
            (contrastive regularizer, weighted by beta).
        init_alphas: [K] initial concentrations (the reference uses ones).
        delta: L2 penalty weight on the concentrations.
        beta: weight of the negative-statistic contrast.
    Returns:
        [K] float64 fitted concentrations.
    """
    ss = np.asarray(ss, np.float64)
    neg_ss = np.asarray(neg_ss, np.float64)
    priors = np.array(init_alphas, np.float64, copy=True)
    current_loss = _loss(priors, ss, neg_ss, beta, delta)

    for _ in range(max_iter):
        gradient = _gradient(priors, ss, neg_ss, beta, delta)
        if float(np.square(gradient).sum()) < GRADIENT_TOL_SQ:
            if verbose:
                print("Converged with small gradient")
            return priors

        # 1) full Newton step
        with np.errstate(over="raise", invalid="raise"):
            try:
                trial = priors + _newton_step(priors, gradient, beta)
                loss = _loss(trial, ss, neg_ss, beta, delta)
                if loss < current_loss:
                    current_loss, priors = loss, trial
                    continue
            except FloatingPointError:
                pass

            # 2) log-space Newton step
            try:
                trial = priors * np.exp(_log_space_step(priors, gradient,
                                                        beta))
                loss = _loss(trial, ss, neg_ss, beta, delta)
            except FloatingPointError:
                if verbose:
                    print("overflow in log-space step, returning")
                return priors

        # 3) gradient ascent with learn-rate backoff until improvement
        loss = np.inf
        learn_rate = 1.0
        while loss > current_loss:
            learn_rate *= 0.9
            trial = priors + gradient * learn_rate
            loss = _loss(trial, ss, neg_ss, beta, delta)
        if learn_rate < LEARN_RATE_TOL:
            if verbose:
                print("Converged with small learn rate")
            return priors
        current_loss, priors = loss, trial

    if verbose:
        print("Reached max iterations")
    return priors


def find_dirichlet_priors_alt(ss, init_alphas, max_iter=1000, delta=1e-2,
                              verbose=False):
    """The reference's ALTERNATE estimator (xview/models/
    dirichletEstimation.py:129-186) — Sklar's solver WITHOUT the
    negative-statistic contrast, and with one numerical difference from the
    beta=0 path of :func:`find_dirichlet_priors`: the L2 penalty's second
    derivative is kept in the Hessian constant (``-trigamma(sum a) +
    2*delta``, dirichletEstimation.py:58), where the main estimator comments
    it out (dirichletDifferentiation.py:61). Same objective, so both
    converge to the same optimum; the Newton trajectories (and therefore
    early-stopped iterates) differ. Kept callable for the same configs the
    reference keeps importable (dirichlet_mix.py:8, commented import).
    """
    ss = np.asarray(ss, np.float64)
    zeros = np.zeros_like(ss)
    priors = np.array(init_alphas, np.float64, copy=True)
    current_loss = _loss(priors, ss, zeros, 0.0, delta)

    def newton_step(alphas, gradient):
        h_const = -special.polygamma(1, alphas.sum()) + 2 * delta
        h_diag = special.polygamma(1, alphas)
        b = ((gradient / h_diag).sum()
             / (1.0 / h_const + (1.0 / h_diag).sum()))
        return (b - gradient) / h_diag

    def log_space_step(alphas, gradient):
        h_const = -special.polygamma(1, alphas.sum()) + 2 * delta
        h_diag = special.polygamma(1, alphas)
        denom = gradient - alphas * h_diag
        z = h_const * (alphas / denom).sum()
        s = ((1.0 / denom) / (1 + z)).sum()
        return gradient / denom * (1 - h_const * alphas * s)

    for _ in range(max_iter):
        gradient = _gradient(priors, ss, zeros, 0.0, delta)
        if float(np.square(gradient).sum()) < GRADIENT_TOL_SQ:
            if verbose:
                print("Converged with small gradient")
            return priors

        with np.errstate(over="raise", invalid="raise"):
            try:
                trial = priors + newton_step(priors, gradient)
                loss = _loss(trial, ss, zeros, 0.0, delta)
                if loss < current_loss:
                    current_loss, priors = loss, trial
                    continue
            except FloatingPointError:
                pass
            try:
                trial = priors * np.exp(log_space_step(priors, gradient))
                loss = _loss(trial, ss, zeros, 0.0, delta)
            except FloatingPointError:
                if verbose:
                    print("overflow in log-space step, returning")
                return priors

        loss = np.inf
        learn_rate = 1.0
        while loss > current_loss:
            learn_rate *= 0.9
            trial = priors + gradient * learn_rate
            loss = _loss(trial, ss, zeros, 0.0, delta)
        if learn_rate < LEARN_RATE_TOL:
            if verbose:
                print("Converged with small learn rate")
            return priors
        current_loss, priors = loss, trial

    if verbose:
        print("Reached max iterations")
    return priors


# --------------------------------------------------------------------------
# Minka fastfit alternatives (reference xview/models/dirichlet_fastfit.py),
# kept callable for the alternate-estimator configs.
# --------------------------------------------------------------------------

def _ipsi(y, tol=1.48e-9, maxiter=10):
    """Inverse digamma via Newton (Minka appendix C)."""
    y = np.asarray(y, np.float64)
    x = np.where(y >= -2.22, np.exp(y) + 0.5, -1.0 / (y - special.psi(1)))
    for _ in range(maxiter):
        x = x - (special.psi(x) - y) / special.polygamma(1, x)
    return x


def loglikelihood_from_statistic(ss, n_obs, alphas, delta=1e-2):
    """delta-penalized Dirichlet log-likelihood from the mean-log-prob
    sufficient statistic (reference dirichlet_fastfit.py:141-155)."""
    alphas = np.asarray(alphas, np.float64)
    return (n_obs * (special.gammaln(alphas.sum())
                     - special.gammaln(alphas).sum()
                     + np.dot(alphas - 1, ss))
            - delta * np.square(alphas).sum())


def fixedpoint_with_sufficient_statistic(ss, n_obs, num_classes, init_alphas,
                                         maxiter=10000, tol=1e-7, delta=1e-2):
    """Minka fixed-point iteration a_k <- ipsi(psi(sum a) + ss_k),
    converging on the penalized log-likelihood difference
    (reference dirichlet_fastfit.py:236-249)."""
    ss = np.asarray(ss, np.float64)
    a = np.array(init_alphas, np.float64, copy=True)
    for _ in range(maxiter):
        a_new = _ipsi(special.psi(a.sum()) + ss)
        if abs(loglikelihood_from_statistic(ss, n_obs, a_new, delta)
               - loglikelihood_from_statistic(ss, n_obs, a, delta)) < tol:
            return a_new
        a = a_new
    return a


def _fit_s(a0, ss, tol=1e-7, maxiter=1000, delta=1e-2):
    """Maximize the precision s = sum(a) with the mean held fixed, via
    Minka's cascade of update rules (reference dirichlet_fastfit.py:282-309)."""
    s1 = a0.sum()
    m = a0 / s1
    m_dot_ss = np.dot(m, ss)
    for _ in range(maxiter):
        s0 = s1
        g = (special.psi(s1) - np.dot(m, special.psi(s1 * m)) + m_dot_ss
             - 2 * delta * s1)
        h = (special.polygamma(1, s1)
             - np.dot(np.square(m), special.polygamma(1, s1 * m))
             - 2 * delta)
        if g + s1 * h < 0:
            s1 = 1.0 / (1.0 / s0 + g / h / s0 ** 2)
        if s1 <= 0:
            s1 = s0 * np.exp(-g / (s0 * h + g))   # Newton on log s
        if s1 <= 0:
            s1 = 1.0 / (1.0 / s0 + g / (s0 ** 2 * h + 2 * s0 * g))  # on 1/s
        if s1 <= 0:
            s1 = s0 - g / h                       # plain Newton
        if s1 <= 0:
            raise FloatingPointError(f"unable to update s from {s0}")
        if abs(s1 - s0) < tol:
            return s1 * m
    raise FloatingPointError(f"precision fit did not converge, s={s1}")


def _fit_m(a0, ss, tol=1e-7, maxiter=1000):
    """Maximize the mean with the precision held fixed
    (reference dirichlet_fastfit.py:311-324)."""
    s = a0.sum()
    for _ in range(maxiter):
        m = a0 / s
        a1 = _ipsi(ss + np.dot(m, special.psi(a0) - ss))
        a1 = a1 / a1.sum() * s
        if np.linalg.norm(a1 - a0) < tol:
            return a1
        a0 = a1
    raise FloatingPointError(f"mean fit did not converge, s={s}")


def meanprecision_with_sufficient_statistic(ss, n_obs, num_classes,
                                            init_alphas, maxiter=10000,
                                            tol=1e-7, delta=1e-2):
    """Minka mean/precision alternating MLE from sufficient statistics
    (reference dirichlet_fastfit.py:252-280): alternate :func:`_fit_s` and
    :func:`_fit_m` until the penalized log-likelihood stops moving; on a
    sub-solver failure return the best iterate so far, as the reference
    does."""
    ss = np.asarray(ss, np.float64)
    a = np.array(init_alphas, np.float64, copy=True)
    for _ in range(maxiter):
        try:
            a_new = _fit_s(a, ss, tol=tol, maxiter=maxiter, delta=delta)
            a_new = _fit_m(a_new, ss, tol=tol, maxiter=maxiter)
            if abs(loglikelihood_from_statistic(ss, n_obs, a_new, delta)
                   - loglikelihood_from_statistic(ss, n_obs, a, delta)) < tol:
                return a_new
            a = a_new
        except FloatingPointError:
            return a
    return a


def sufficient_statistic_from_samples(samples):
    """Mean log probabilities over a sample set — the Dirichlet sufficient
    statistic (reference dirichletDifferentiation.py:23-34
    ``getSufficientStatistic``, vectorized)."""
    return np.log(np.asarray(samples, np.float64)).mean(0)


def dirichlet_loglikelihood(samples, alphas):
    """Log-likelihood of N simplex samples under Dir(alphas)
    (reference dirichlet_fastfit.py:118-143 ``loglikelihood``)."""
    samples = np.asarray(samples, np.float64)
    alphas = np.asarray(alphas, np.float64)
    n = samples.shape[0]
    return float(
        n * (special.gammaln(alphas.sum()) - special.gammaln(alphas).sum())
        + np.dot(alphas - 1, np.log(samples).sum(0)))


def likelihood_ratio_test(samples1, samples2, method="meanprecision",
                          maxiter=10000, delta=1e-2):
    """Likelihood-ratio test for a difference between two sets of observed
    proportions (reference dirichlet_fastfit.py:50-92 ``test``).

    Fits Dirichlet MLEs to each set and to the pooled set; the statistic is
    -2 log of the likelihood ratio, with a chi-squared(K) p-value as in the
    reference.

    Returns:
        (D, p_value, a_pooled, a_1, a_2)
    """
    samples1 = np.asarray(samples1, np.float64)
    samples2 = np.asarray(samples2, np.float64)
    if samples1.shape[1] != samples2.shape[1]:
        raise ValueError("sample sets must have the same number of columns")
    num_classes = samples1.shape[1]

    fitters = {
        "fixedpoint": fixedpoint_with_sufficient_statistic,
        "meanprecision": meanprecision_with_sufficient_statistic,
    }
    try:
        fit = fitters[method]
    except KeyError:
        raise ValueError(f"unknown method '{method}'") from None

    def mle(samples):
        # moment-matching init, as the reference's mle() uses
        # (dirichlet_fastfit.py:377-381 _init_a)
        mean = samples.mean(0)
        sq_mean = np.square(samples).mean(0)
        init = (mean[0] - sq_mean[0]) / (sq_mean[0] - mean[0] ** 2) * mean
        ss = sufficient_statistic_from_samples(samples)
        return fit(ss, samples.shape[0], num_classes, init, maxiter=maxiter,
                   delta=delta)

    pooled = np.vstack([samples1, samples2])
    a0, a1, a2 = mle(pooled), mle(samples1), mle(samples2)
    statistic = 2 * (dirichlet_loglikelihood(samples1, a1)
                     + dirichlet_loglikelihood(samples2, a2)
                     - dirichlet_loglikelihood(pooled, a0))
    from scipy import stats
    return statistic, float(stats.chi2.sf(statistic, num_classes)), a0, a1, a2


def dirichlet_mle_from_samples(samples, maxiter=1000, tol=1e-9):
    """Plain Dirichlet MLE from probability samples (for tests/diagnostics)."""
    samples = np.asarray(samples, np.float64)
    ss = np.log(samples).mean(0)
    a = np.ones(samples.shape[1])
    for _ in range(maxiter):
        a_new = _ipsi(special.psi(a.sum()) + ss)
        if np.abs(a_new - a).max() < tol:
            return a_new
        a = a_new
    return a
