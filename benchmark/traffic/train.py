"""Training an expert through ``Estimator.fit``, the entry users call, on an
in-memory dict of seeded frames (``fit`` shuffles it by the model's seed
and prefetches each batch to the card). ``train_img_per_s`` is the images
consumed over the window, which runs ``fit`` in chunks of
``chunk_steps`` steps, each ended by a synchronise, until ``--seconds``
have passed.

Set-up builds the one model object, runs its first ``checked_steps``
steps in one ``fit`` call (their losses, the first gradient as Adam's
first moment holds it after one step, and the parameters after the last
are kept for the check), warms up further with ``warmup_steps``, and
hands the same object to the window. The check runs the reference's
steps from the same weights on the same batches.

Parameters: ``pool_frames``, ``checked_steps``, ``warmup_steps``,
``chunk_steps``, ``trace_steps`` (a ``fit`` call of its own, traced, in
the traced run's window).
"""

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.frames import learnable_frames
from benchmark.harness.serving import now, program_output, record
from benchmark.harness.weights import make_weights
from benchmark.reference.train import run_steps


class Client:
    unit = "step"

    def __init__(self, run):
        self.run = run
        self.config = run.config
        self.traffic = run.traffic
        self.device = run.device
        self.net = None

    def _specs(self):
        train = self.config["train"]
        modality = train["modality"]
        return self.run.family.variable_specs(
            self.config, modality, self.config["modalities"][modality],
            train["batch_normalization"])

    def _fit(self, steps):
        with record("fit_chunk"), program_output():
            self.net.fit(self.data, steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        config, seeds, train = self.config, self.run.seeds, self.config["train"]
        with program_output():
            self.net = self.run.family.build_trainer(config, self.device,
                                                     seeds["program"])
        weights = make_weights(self._specs(), seeds["weights"], self.device)
        if set(weights) != set(self.net.variables):
            raise RuntimeError("the program's variables differ from the "
                               "benchmark's")
        self.net.variables.update(weights)
        self.data = learnable_frames(self.traffic["pool_frames"],
                                     train["height"], train["width"],
                                     config["num_classes"], seeds["frames"],
                                     self.device)
        self.data = {train["modality"]: self.data["rgb"],
                     "labels": self.data["labels"]}
        if self.run.program_hook is not None:
            self.run.program_hook(self)
        trainable = [k for k, t in self.net.trainable.items() if t]
        if set(trainable) != set(self.run.family.trainable(self._specs())):
            raise RuntimeError("the program trains other variables than "
                               "the benchmark's family says")
        start = {k: self.net.variables[k] for k in trainable}
        losses, first = [], {}
        step = self.net._train_step

        def recorded(variables, opt_state, batch):
            out = step(variables, opt_state, batch)
            losses.append(out[2].detach())
            if not first:
                first.update(out[1].get("mu", {}))
            return out

        self.net._train_step = recorded
        try:
            self._fit(self.traffic["checked_steps"])
        finally:
            del self.net._train_step
        b1 = self.net._optimizer.b1
        self.program = {
            "losses": [float(x) for x in losses],
            "grad_norms": compare.norms({k: first[k] / (1 - b1)
                                         for k in trainable if k in first}),
            "change_norms": compare.norms(
                {k: self.net.variables[k] - start[k] for k in trainable}),
        }
        for k in trainable:
            self.program["grad_norms"].setdefault(k, 0.0)
        del start, first
        self._fit(self.traffic["warmup_steps"])

    def window(self, seconds, stretch=None):
        chunk = self.traffic["chunk_steps"]
        batch = self.config["train"]["batch"]
        steps, traced = 0, stretch is None
        start = now()
        while now() - start < seconds or not traced:
            if not traced and steps >= chunk:
                n = self.traffic["trace_steps"]
                stretch.begin()
                self._fit(n)
                stretch.end(n)
                traced = True
            else:
                n = chunk
                self._fit(n)
            steps += n
        elapsed = now() - start
        return {"metrics": {"train_img_per_s": steps * batch / elapsed},
                "units": steps, "images": steps * batch, "seconds": elapsed,
                "attempted": steps, "failed": 0}

    def release(self):
        self.net = None

    def check(self):
        return compare.training_readings(self.program, self.reference())[0]

    def reference(self):
        """The reference's losses, first-gradient norms and change norms
        over the checked steps, from the same weights and batches."""
        train = self.config["train"]
        modality = train["modality"]
        specs = self._specs()
        weights = make_weights(specs, self.run.seeds["weights"], self.device)
        # the order fit takes the dict in: a RandomState of the model's
        # seed permutes the frames each epoch
        total = self.traffic["pool_frames"]
        order = np.random.RandomState(self.run.seeds["program"]).permutation(
            total)
        b = train["batch"]
        batches = []
        for i in range(self.traffic["checked_steps"]):
            rows = order[i * b:(i + 1) * b]
            x = torch.from_numpy(self.data[modality][rows]).to(self.device)
            y = torch.from_numpy(self.data["labels"][rows]).to(self.device)
            batches.append((x.permute(0, 3, 1, 2), y))
        family = self.run.family
        trainable = family.trainable(specs)

        def forward(w, x):
            return family.reference_scores(w, modality, x,
                                           train["batch_normalization"],
                                           train=True)

        losses, grads, after = run_steps(
            weights, trainable, batches, forward, train["learning_rate"])
        return {"losses": losses, "grad_norms": compare.norms(grads),
                "change_norms": compare.norms(
                    {k: after[k] - weights[k] for k in trainable})}
