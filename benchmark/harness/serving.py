"""What the serving clients share: the program's fusion model with the
benchmark's weights and confusion matrices, the frame pool, a server
warmed up on the cell's own shapes, a seeded sample of the window's
outputs, and the check of that sample against the reference.

The sample holds the fused labels the window delivered. Once the window
has closed, the same model in the same serving mode gives the experts'
class probabilities of the sampled frames, through servers of the
window's group size that return them in place of the labels; the check
holds both against the reference.
"""

import contextlib
import sys
from time import perf_counter as now  # noqa: F401  (the clients' clock)

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.frames import serving_pool
from benchmark.harness.weights import make_confusion_matrices, make_weights
from benchmark.reference.bayes import decision_table


class Reservoir:
    """A uniform sample of ``size`` items of a stream (Vitter's algorithm
    R), drawn from ``seed``."""

    def __init__(self, size, seed):
        self.size = size
        self.items = []
        self._seen = 0
        self._rng = np.random.RandomState(seed)

    def offer(self, item_fn):
        """Offer the next item; ``item_fn()`` makes it only if it is kept."""
        t = self._seen
        self._seen += 1
        if t < self.size:
            self.items.append(item_fn())
            return
        j = self._rng.randint(0, t + 1)
        if j < self.size:
            self.items[j] = item_fn()


def record(name):
    """A ``record_function`` range of the benchmark's own, ``bench.<name>``."""
    return torch.autograd.profiler.record_function(f"bench.{name}")


def program_output():
    """Where the program's own prints go: standard error, so that the
    result stays the last line of standard output."""
    return contextlib.redirect_stdout(sys.stderr)


class ServingClient:
    """Base of the serving clients; ``unit`` is a fused frame."""

    unit = "frame"

    def __init__(self, run):
        self.run = run
        self.config = run.config
        self.traffic = run.traffic
        self.device = run.device
        self.net = None
        self.server = None
        self.sample = None
        self.probs = None

    # ------------------------------------------------------------- set-up
    def _specs(self):
        family, config = self.run.family, self.config
        serve = config["serve"]
        specs = []
        for modality, channels in config["modalities"].items():
            specs += family.variable_specs(config, modality, channels,
                                           serve["batch_normalization"])
        return specs

    def setup(self):
        config, seeds = self.config, self.run.seeds
        serve = config["serve"]
        self.matrices = make_confusion_matrices(
            list(config["modalities"]), config["num_classes"],
            seeds["matrices"])
        with program_output():
            self.net = self.run.family.build_fusion(
                config, self.matrices, self.device, seeds["program"])
        weights = make_weights(self._specs(), seeds["weights"], self.device)
        missing = set(self.net.variables) ^ set(weights)
        if missing:
            raise RuntimeError(f"the program's variables differ from the "
                               f"benchmark's: {sorted(missing)[:8]}")
        for name, value in weights.items():
            if tuple(self.net.variables[name].shape) != tuple(value.shape):
                raise RuntimeError(f"{name}: the program holds "
                                   f"{tuple(self.net.variables[name].shape)}"
                                   f", the benchmark {tuple(value.shape)}")
        self.net.variables.update(weights)
        if self.run.program_hook is not None:
            self.run.program_hook(self)
        self.pool = serving_pool(config["modalities"],
                                 self.traffic["pool_frames"],
                                 serve["height"], serve["width"],
                                 seeds["frames"], self.device)
        self.server = self.make_server()
        with program_output():
            for _ in self.server.predict_stream(
                    self.pool[i % len(self.pool)]
                    for i in range(self.traffic["warmup_frames"])):
                pass
        self.synchronize()

    def make_server(self):
        from modular_semantic_segmentation_torch.serving import \
            InferenceServer
        return InferenceServer(self.net, unroll=self.traffic["unroll"],
                               max_in_flight=self.traffic["max_in_flight"])

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def new_sample(self):
        self.sample = Reservoir(self.traffic["checked_frames"],
                                self.run.seeds["sample"])
        return self.sample

    def release(self):
        """Read the sampled frames' expert probabilities from the program,
        then free its state before the reference runs."""
        if self.sample is not None and self.net is not None:
            self.probs = self._program_probs()
        self.server = None
        self.net = None

    def _program_probs(self):
        """``{pool index: [each expert's probabilities [H, W, K]]}`` of the
        sampled frames."""
        from modular_semantic_segmentation_torch.serving import \
            InferenceServer
        indices = sorted({index for index, _ in self.sample.items})
        frames = [self.pool[i] for i in indices]
        probs = {i: [] for i in indices}
        with program_output():
            for modality in self.config["modalities"]:
                server = InferenceServer(
                    self.net, unroll=self.traffic["unroll"],
                    max_in_flight=self.traffic["max_in_flight"],
                    output_attr=f"{modality}_prob")
                for i, prob in zip(indices, server.predict_stream(frames)):
                    probs[i].append(torch.from_numpy(prob))
        return probs

    # -------------------------------------------------------------- check
    def check(self):
        """``{name: reading}`` of the sampled outputs against the
        reference; the limits are the cell's."""
        config, family = self.config, self.run.family
        serve = config["serve"]
        weights = make_weights(self._specs(), self.run.seeds["weights"],
                               self.device)
        table = torch.from_numpy(decision_table(
            [self.matrices[m] for m in config["modalities"]])).to(
                self.device)
        widest, mismatched, pixels = 0.0, 0, 0
        off, counted = 0, 0
        with torch.no_grad():
            for index, label in sorted(self.sample.items,
                                       key=lambda item: item[0]):
                frame = self.pool[index]
                scores = []
                for modality in config["modalities"]:
                    x = torch.from_numpy(frame[modality][None]).to(
                        self.device).permute(0, 3, 1, 2)
                    s, _ = family.reference_scores(
                        weights, modality, x,
                        serve["batch_normalization"])
                    scores.append(s[0])
                gap, miss, count = compare.label_readings(
                    torch.from_numpy(label).to(self.device), scores, table)
                widest = max(widest, gap)
                mismatched += miss
                pixels += count
                for prob, s in zip(self.probs[index], scores):
                    o, c = compare.expert_readings(prob.to(self.device), s)
                    off, counted = off + o, counted + c
        return {"label_gap": widest,
                "label_mismatch": mismatched / max(pixels, 1),
                "score_off_share": off / max(counted, 1)}
