"""Training steps of an expert: masked cross entropy, backpropagation and
Adam (Kingma and Ba, 2015, with the epsilon outside the root), the moving
statistics of batch norm updated from the batch's.

The loss is the mean over labelled pixels of -log p(true class); a label
outside [0, K) marks a pixel that is left out.
"""

import torch


def masked_cross_entropy(scores, labels):
    """``scores`` [N, K, H, W], ``labels`` [N, H, W] int."""
    log_p = torch.log_softmax(scores, dim=1)
    valid = (labels >= 0) & (labels < scores.shape[1])
    picked = torch.gather(log_p, 1, labels.clamp(0, scores.shape[1] - 1)
                          .unsqueeze(1).long()).squeeze(1)
    return -(picked * valid).sum() / (1e-20 + valid.sum())


class Adam:
    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {}
        self.v = {}

    def step(self, params, grads):
        """New parameters; ``params`` and ``grads`` are name -> tensor."""
        self.t += 1
        out = {}
        for name, g in grads.items():
            m = self.b1 * self.m.get(name, 0.0) + (1 - self.b1) * g
            v = self.b2 * self.v.get(name, 0.0) + (1 - self.b2) * g * g
            self.m[name], self.v[name] = m, v
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            out[name] = params[name] - self.lr * m_hat / (
                torch.sqrt(v_hat) + self.eps)
        return out


def run_steps(weights, trainable, batches, forward, learning_rate):
    """Train ``weights`` (name -> tensor) on ``batches`` (each ``(x NCHW,
    labels)``), ``forward(weights, x) -> (scores, layers)``.

    Returns (losses, gradients of the first step, weights after the last
    step), all detached."""
    adam = Adam(learning_rate)
    weights = dict(weights)
    losses, first_grads = [], None
    for x, labels in batches:
        leaves = {k: weights[k].detach().requires_grad_()
                  for k in trainable}
        with torch.enable_grad():
            scores, layers = forward({**weights, **leaves}, x)
            loss = masked_cross_entropy(scores, labels)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        if first_grads is None:
            first_grads = grads
        weights.update({k: v.detach() for k, v in
                        adam.step(weights, grads).items()})
        weights.update(layers.moving)
        losses.append(float(loss.detach()))
    return losses, first_grads, weights
