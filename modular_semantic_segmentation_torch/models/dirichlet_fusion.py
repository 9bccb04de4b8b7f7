"""Dirichlet fusion (counterpart of the JAX package's
``models/dirichlet_fusion.py``).

Per (expert, class) a Dirichlet distribution over the expert's softmax
simplex, fitted by EM on a held-out measure set (:meth:`fit`: the
per-class sums of log expert probabilities on the device, the solvers of
``ops/dirichlet_estimation.py`` on the host in float64), passed in as
``dirichlet_params``, or loaded from a past run (``measurement_exp``).
With ``use_pallas`` the fused label comes from the one-pass kernel of
``ops/cuda/dirichlet.py`` (the name of the JAX option is kept); otherwise
from the plain ``ops/fusion_math.dirichlet_fusion``.
"""

from copy import deepcopy

import numpy as np
import torch

from modular_semantic_segmentation_torch.ops import dirichlet_estimation as de
from modular_semantic_segmentation_torch.ops import fusion_math as fm
from modular_semantic_segmentation_torch.ops.cuda import dirichlet
from modular_semantic_segmentation_torch.ops.variables import Ctx
from modular_semantic_segmentation_torch.models.fusion_base import (
    FusionModel, test_pipeline)
from modular_semantic_segmentation_torch.utils.data_io import iterate_batches


def load_measurements(exp_id):
    """The Dirichlet parameters of a past run (of either package): its
    ``counts.npz`` artifact, {modality: [K, C], 'class_counts': [C]}. The
    directory backend gives a path, the zip backend a file object; numpy
    reads both."""
    from modular_semantic_segmentation_torch.utils.experiment import \
        ExperimentData
    with np.load(ExperimentData(exp_id).get_artifact("counts.npz")) as npz:
        return {k: npz[k] for k in npz.files}


class DirichletFusion(FusionModel):
    """Mixture of CNN experts following the 'dirichlet mix' method.

    Args:
        prefixes: dict {modality: prefix} of the experts (or
            ``modalities``, with prefix == modality name).
        sigma: Dirichlet temperature.
        delta, beta: EM regularizers (see ops/dirichlet_estimation.py).
        estimator: 'differentiation' (default, the penalized contrastive
            solver) | 'estimation' (Sklar's solver without the negative
            statistic) | 'fixedpoint' | 'meanprecision' (Minka fastfit).
        class_prior: 'data' | 'uniform' | float.
        dirichlet_params: {modality: [K, C] concentrations,
            'class_counts': [C]}, or ``measurement_exp``, the id of a past
            run whose ``counts.npz`` holds them. Without either the model
            is in its measurement phase and predicts zeros until
            :meth:`fit`.
        use_pallas: fuse with the one-pass kernel.
    """

    def __init__(self, output_dir=None, **config):
        standard_config = {"learning_rate": 0.0, "sigma": 1.0,
                           "class_prior": "data", "delta": 1e-2,
                           "beta": 1e-2, "estimator": "differentiation"}
        standard_config.update(config)
        if "prefixes" not in standard_config:
            standard_config["prefixes"] = {
                m: m for m in standard_config.pop("modalities")}
        measurements = standard_config.pop("dirichlet_params", None)
        if "measurement_exp" in config:
            measurements = load_measurements(config["measurement_exp"])

        modalities = list(standard_config["prefixes"].keys())
        if measurements is not None:
            self.dirichlet_params = {
                m: np.asarray(measurements[m], "float32")
                for m in modalities}
            self.class_counts = np.asarray(measurements["class_counts"],
                                           "float32")
        else:
            self.dirichlet_params = None
            self.class_counts = None
            print("WARNING: Could not yet import measurements, you need to "
                  "fit this model first.")
        self._tables = {}
        FusionModel.__init__(self, name="DirichletFusion",
                             output_dir=output_dir, **standard_config)

    def _serving_state(self):
        # the kernel takes its tables by value, and fit makes new ones
        return super()._serving_state() + (self._tables,)

    def _eager_serving_reason(self):
        if not self.config.get("use_pallas"):
            return ("the plain fusion copies its parameters from host "
                    "arrays to the device every frame")
        return None

    def _prior(self):
        data_prior = self.class_counts / (1e-20 + self.class_counts.sum())
        return fm.class_prior(self.config["class_prior"], data_prior)

    def _kernel_tables(self, num_classes):
        """(coeffs, bias) of the kernel, built on first use; those a traced
        program builds (``serving.export_serving``) stay in the program.
        They stay on the host on every device: the kernel takes them by
        value."""
        tables = (dict(self._tables) if torch.compiler.is_compiling()
                  else self._tables)
        if num_classes not in tables:
            coeffs, bias = dirichlet.dirichlet_tables(
                [self.dirichlet_params[m] for m in self.modalities],
                self._prior(), self.config["sigma"], num_classes)
            tables[num_classes] = (torch.from_numpy(coeffs),
                                   torch.from_numpy(bias))
        return tables[num_classes]

    def _fusion(self, expert_outputs):
        # normalize probs defensively, as the reference does
        probs = {m: expert_outputs[m]["prob"] /
                 torch.sum(expert_outputs[m]["prob"], dim=3, keepdim=True)
                 for m in self.modalities}
        out = {f"{m}_norm_prob": probs[m] for m in self.modalities}
        if self.dirichlet_params is None:
            # measurement phase: no fusion defined yet
            cls = expert_outputs[self.modalities[0]]["classification"]
            out["prediction"] = torch.zeros(cls.shape, dtype=torch.int32,
                                            device=cls.device)
            out["fused_score"] = torch.zeros(
                tuple(cls.shape) + (self.config["num_classes"],),
                dtype=torch.float32, device=cls.device)
            return out
        if self.config.get("use_pallas"):
            first = probs[self.modalities[0]]
            k = first.shape[-1]
            coeffs, bias = self._kernel_tables(k)
            # each expert's probabilities are read where they lie
            out["prediction"] = dirichlet.dirichlet_label(
                [probs[m].reshape(-1, k) for m in self.modalities], coeffs,
                bias).reshape(first.shape[:-1])
            return out
        fused = fm.dirichlet_fusion(
            [probs[m] for m in self.modalities],
            [self.dirichlet_params[m] for m in self.modalities],
            self._prior(), sigma=self.config["sigma"])
        out["prediction"] = torch.argmax(fused, 3).to(torch.int32)
        out["fused_score"] = fused
        return out

    # -------------------------------------------------------------- fitting
    def _stats_step(self, batch):
        """Sufficient statistics of one batch on the device. The experts
        run in float32 whatever ``compute_dtype`` is, as the JAX package's
        stats step does (its ``Ctx`` defaults to float32); like it, the
        batch goes in without ``_preprocess``."""
        num_classes = self.config["num_classes"]
        out = {}
        with torch.inference_mode():
            ctx = Ctx(self.variables, compute_dtype=torch.float32,
                      kernel_cache=self._kernel_cache)
            for m in self.modalities:
                prob = test_pipeline(ctx, batch[m],
                                     self.config["prefixes"][m],
                                     **self.config)["prob"]
                ss, counts = fm.dirichlet_sufficient_statistics(
                    prob, batch["labels"], num_classes)
                out[m] = ss
                out["class_counts"] = counts
        return out

    def _get_sufficient_statistic(self, data):
        """Per-true-class sums of log expert probabilities over the measure
        set: each batch on the device, accumulated on the host in float64
        (the class counts in int64). Padded batch rows carry label -1 and
        count nowhere."""
        num_classes = self.config["num_classes"]
        counts = {m: np.zeros((num_classes, num_classes))
                  for m in self.modalities}
        class_counts = np.zeros(num_classes, "int64")
        for batch, _ in iterate_batches(data, self.config["batchsize"]):
            out = self._stats_step(self._batch_to_device(batch))
            for m in self.modalities:
                counts[m] += out[m].cpu().numpy().astype(np.float64)
            class_counts += out["class_counts"].cpu().numpy().astype("int64")
        return counts, class_counts

    def _fit_sufficient_statistic(self, counts, class_counts):
        """Per-class Dirichlet EM on the host in float64, with the solver
        of config 'estimator'; classes without pixels keep concentrations
        of one."""
        num_classes = self.config["num_classes"]
        estimator = self.config.get("estimator", "differentiation")

        def solve(ss, neg_ss, n_obs):
            prior = np.ones(num_classes, "float64")
            if estimator == "differentiation":
                return de.find_dirichlet_priors(
                    ss, neg_ss, prior, max_iter=10000,
                    delta=self.config["delta"], beta=self.config["beta"])
            if estimator == "estimation":
                return de.find_dirichlet_priors_alt(
                    ss, prior, max_iter=10000, delta=self.config["delta"])
            if estimator in ("fixedpoint", "meanprecision"):
                fit = (de.fixedpoint_with_sufficient_statistic
                       if estimator == "fixedpoint"
                       else de.meanprecision_with_sufficient_statistic)
                return fit(ss, n_obs, num_classes, prior,
                           delta=self.config["delta"])
            raise ValueError(f"unknown estimator '{estimator}'")

        def dirichlet_em(measurements):
            params = np.ones((num_classes, num_classes), "float64")
            for c in range(num_classes):
                if class_counts[c] == 0:
                    continue
                ss = (measurements[c, :] / class_counts[c]).astype("float64")
                neg_ss = (measurements.sum(0) - measurements[c, :]) / \
                    (class_counts.sum() - class_counts[c])
                params[:, c] = solve(ss, neg_ss, class_counts[c])
            return params

        self.dirichlet_params = {m: dirichlet_em(counts[m]).astype("float32")
                                 for m in self.modalities}
        self.class_counts = class_counts.astype("float32")
        # the kernel's coefficients were made from the old parameters
        self._tables = {}

    def prediction_difference(self, data):
        """Per-branch diagnostics for the given data: fused label and score
        and each expert's normalized probabilities."""
        ret = {"fused_label": self.predict(data),
               "fused_score": self.predict(data,
                                           output_attr="fused_score")}
        for m in self.modalities:
            ret[f"{m}_prob"] = self.predict(data,
                                            output_attr=f"{m}_norm_prob")
        return ret

    def fit(self, data, *args, **kwargs):
        """Fit the Dirichlet parameters on the measure set. Returns the
        params dict with 'class_counts'."""
        counts, class_counts = self._get_sufficient_statistic(data)
        print("INFO: Measurements of classifiers finished, now EM")
        self._fit_sufficient_statistic(counts, class_counts)
        print("INFO: DirichletFusion fitted to data")
        ret = deepcopy(self.dirichlet_params)
        ret["class_counts"] = self.class_counts
        return ret
