"""The port's parallel layer (``parallel/``) against the JAX package's, on
the CPU: meshes, data parallelism (with microbatching and a multislice
mesh), tensor parallelism, the pipeline and expert dispatch.

The port's ranks are 4 processes over gloo, started by
``parallel.launch.launch``; they import this module for its rank
functions, so JAX is imported only inside the JAX fixtures here (each
rank reports whether JAX got loaded). The JAX package runs on the
8-device virtual CPU mesh of ``tests/conftest.py``, with the devices it
needs. Weights cross over with ``models/params.from_jax_variables`` (as
numpy into the ranks), inputs come from the synthetic dataset.

Tolerances are those of the unsharded port tests: labels exact where the
top two probabilities lie more than 1e-5 apart, probabilities within 1e-5
of the largest, one SGD(1.0) step's deltas (the gradient) within 1e-3 of
each tensor's largest delta, and JAX's own gates for its trajectories.
Sharding adds only reduction order.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from modular_semantic_segmentation_torch.datasets import get_dataset
from modular_semantic_segmentation_torch.parallel import launch

RANKS = 4
WIDTH = 0.25  # channel_factor: VGG16 widths 16 .. 128
DP_KWARGS = dict(prefix="rgb", modality="rgb", num_units=4, batchsize=8,
                 learning_rate=0.01, seed=3, batch_normalization=False,
                 channel_factor=WIDTH)
CONVERGE_KWARGS = dict(prefix="rgb", modality="rgb", num_units=4,
                       batchsize=8, learning_rate=0.05, seed=5,
                       channel_factor=WIDTH)
TP_KWARGS = dict(prefix="rgb", modality="rgb", num_units=4, batchsize=2,
                 seed=11, channel_factor=WIDTH)
TP_TRAIN_KWARGS = dict(prefix="rgb", modality="rgb", num_units=4,
                       batchsize=4, learning_rate=0.001, seed=3,
                       batch_normalization=False, channel_factor=WIDTH)
SP_DESCRIPTION = ({"labels": np.int32, "rgb": np.float32,
                   "depth": np.float32},
                  {"rgb": (None, None, 3), "depth": (None, None, 1),
                   "labels": (None, None)}, 5)
SP_KWARGS = dict(prefix="rgb", modality="rgb", num_units=4, batchsize=1,
                 batch_normalization=True, dropout_rate=0.0, seed=7,
                 channel_factor=WIDTH)
BAYES_KWARGS = dict(num_units=4, expert_model="fcn", channel_factor=WIDTH,
                    prefixes={"rgb": "rgb", "depth": "depth"}, batchsize=1,
                    seed=13)
FUSION_KWARGS = dict(num_units=4, expert_model="fcn", channel_factor=WIDTH,
                     prefixes={"rgb": "rgb", "depth": "depth"},
                     batchsize=2)


def _data(num_train=8):
    return get_dataset("unittest")(height=32, width=32, num_train=num_train,
                                   num_measure=2, num_test=4)


def _batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _scaled_error(got, want):
    """Largest |got - want| over the largest |want| (at least 1e-3)."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-3)


def _ties_ok(got, want, prob, rtol=1e-5):
    """Labels equal wherever the reference's top two probabilities lie
    more than ``rtol`` apart."""
    top2 = np.sort(prob, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > rtol
    return bool(np.all(got[clear] == want[clear])), float(clear.mean())


def _counts(predictions, labels, num_classes=5):
    """Kernel A's plain version: [K, K] counts."""
    from modular_semantic_segmentation_torch.ops.cuda.confusion import \
        confusion_counts_plain
    return confusion_counts_plain(torch.from_numpy(predictions),
                                  torch.from_numpy(labels),
                                  num_classes).numpy().astype(np.float32)


# ---------------------------------------------- the ranks (no JAX in here)

def _port_model(name, variables, description, sgd=False, **kwargs):
    from modular_semantic_segmentation_torch.models import get_model
    from modular_semantic_segmentation_torch.models.params import \
        from_jax_variables
    from modular_semantic_segmentation_torch.ops import optimizers
    from modular_semantic_segmentation_torch.ops.variables import \
        split_trainable
    net = get_model(name)(data_description=description, device="cpu",
                          **kwargs)
    net.variables = from_jax_variables(variables, device="cpu")
    if sgd:
        net._optimizer = optimizers.SGD(1.0)
    if not net.custom_training:
        net.opt_state = net._optimizer.init(
            split_trainable(net.variables, net.trainable)[0])
    return net


def _numpy(variables):
    return {k: v.detach().numpy().copy() for k, v in variables.items()}


def _mesh_checks():
    import torch.distributed as dist
    from modular_semantic_segmentation_torch.parallel import (
        make_mesh, make_multislice_mesh)
    from modular_semantic_segmentation_torch.parallel import collectives
    out = {"mesh": make_mesh({"data": 2, "expert": 2}, device="cpu").shape}
    try:
        make_mesh({"data": 3}, device="cpu")
    except ValueError as error:
        out["mesh_error"] = str(error)
    mesh = make_multislice_mesh(2, {"data": 2}, device="cpu")
    out["multislice"] = mesh.shape
    value = torch.tensor([float(dist.get_rank())])
    out["psum"] = float(collectives.all_reduce_(
        value, mesh.axis(("slice", "data"))))
    out["slice_order"] = (mesh.axis("slice").index, mesh.axis("data").index)
    try:
        make_multislice_mesh(3, device="cpu")
    except ValueError as error:
        out["multislice_error"] = str(error)
    return out


def _dp_checks(refs):
    from modular_semantic_segmentation_torch.parallel import (
        distribute, make_mesh, make_multislice_mesh)
    description, batch = refs["description"], refs["batch"]
    out = {}
    # one SGD(1.0) step: its delta is minus the global gradient
    net = _port_model("simple_fcn", refs["dp_vars"], description, sgd=True,
                      **DP_KWARGS)
    distribute(net, make_mesh({"data": RANKS}, device="cpu"))
    new, _, loss = net._train_step(net.variables, net.opt_state, batch)
    out["dp_loss"] = float(loss)
    out["dp_delta"] = {k: (new[k] - net.variables[k]).numpy()
                       for k, train in net.trainable.items() if train}
    # an adam step, then the eval path: predict gathers, score sums the
    # ranks' kernel-A counts
    net = _port_model("simple_fcn", refs["dp_vars"], description,
                      **DP_KWARGS)
    distribute(net, make_mesh({"data": RANKS}, device="cpu"))
    net.variables, net.opt_state, loss = net._train_step(
        net.variables, net.opt_state, batch)
    out["dp_adam_loss"] = float(loss)
    test = refs["test"]
    out["dp_prediction"] = net.predict(test)
    out["dp_prob"] = net.predict(test, output_attr="prob")
    out["dp_score"] = net.score(test)[1]
    # microbatches of 4 over a 2-wide data axis of a 2x2 mesh
    net = _port_model("simple_fcn", refs["dp_vars"], description, sgd=True,
                      microbatch_size=4, **DP_KWARGS)
    distribute(net, make_mesh({"data": 2, "unused": 2}, device="cpu"))
    new, _, loss = net._train_step(net.variables, net.opt_state, batch)
    out["micro_loss"] = float(loss)
    out["micro_delta"] = {k: (new[k] - net.variables[k]).numpy()
                          for k, train in net.trainable.items() if train}
    # 20 adam steps with batch norm; the replicas stay in sync
    conv = refs["converge"]
    net = _port_model("simple_fcn", conv["vars"], description,
                      **CONVERGE_KWARGS)
    distribute(net, make_mesh({"data": RANKS}, device="cpu"))
    losses = []
    for step_batch in conv["batches"]:
        net.variables, net.opt_state, loss = net._train_step(
            net.variables, net.opt_state, step_batch)
        losses.append(float(loss))
    out["converge_losses"] = losses
    out["converge_vars"] = _numpy(net.variables)
    out["converge_score"] = net.score(test)[0]["total_accuracy"]
    # the multislice mesh's hierarchical gradient against the flat one
    steps = {}
    for kind in ("flat", "hybrid"):
        net = _port_model("simple_fcn", conv["vars"], description,
                          **CONVERGE_KWARGS)
        if kind == "flat":
            distribute(net, make_mesh({"data": RANKS}, device="cpu"))
        else:
            distribute(net, make_multislice_mesh(2, {"data": 2},
                                                 device="cpu"),
                       data_axis=("slice", "data"))
        new, _, loss = net._train_step(net.variables, net.opt_state,
                                       conv["batches"][0])
        steps[kind] = (float(loss), new["rgb/conv1_1/kernel"].numpy())
    out["multislice_steps"] = steps
    return out


def _tp_checks(refs):
    from modular_semantic_segmentation_torch.parallel import (
        distribute_tp, make_mesh)
    description, out = refs["description"], {}
    net = _port_model("simple_fcn", refs["tp_vars"], description,
                      **TP_KWARGS)
    distribute_tp(net, make_mesh({"data": 2, "model": 2}, device="cpu"))
    out["tp_shapes"] = {k: tuple(v.shape) for k, v in net.variables.items()}
    out["tp_spec"] = net._parallel.shardings["rgb/conv2_1/kernel"].spec
    out["tp_prob"] = net.predict(refs["tp_batch"], output_attr="prob")
    net.quantize_for_serving(refs["tp_batch"], num_batches=1,
                             min_channels=8, min_pixels=0)
    out["tp_int8_prob"] = net.predict(refs["tp_batch"], output_attr="prob")
    net.dequantize_serving()
    out["tp_dequantized_shape"] = tuple(
        net.variables["rgb/conv2_1/kernel"].shape)
    out["tp_dequantized_prob"] = net.predict(refs["tp_batch"],
                                             output_attr="prob")
    # two adam steps of TP x DP
    net = _port_model("simple_fcn", refs["tp_train_vars"], description,
                      **TP_TRAIN_KWARGS)
    distribute_tp(net, make_mesh({"data": 2, "model": 2}, device="cpu"))
    losses = []
    for step_batch in refs["tp_train_batches"]:
        net.variables, net.opt_state, loss = net._train_step(
            net.variables, net.opt_state, step_batch)
        losses.append(float(loss))
    out["tp_train_losses"] = losses
    out["tp_train_kernel"] = net.variables["rgb/conv1_1/kernel"].numpy()
    out["tp_model_index"] = net._parallel.ctx_kwargs[
        "tensor_parallel"].axis.index
    out["tp_train_shape"] = tuple(net.variables["rgb/conv2_1/kernel"].shape)
    out["tp_opt_shape"] = tuple(
        net.opt_state["mu"]["rgb/conv2_1/kernel"].shape)
    return out


def _spatial_checks(refs):
    from modular_semantic_segmentation_torch.models.adapnet import adapnet
    from modular_semantic_segmentation_torch.models.params import \
        from_jax_variables
    from modular_semantic_segmentation_torch.models.simple_fcn import fcn
    from modular_semantic_segmentation_torch.parallel import (
        distribute_spatial, make_mesh)
    from modular_semantic_segmentation_torch.parallel.spatial import (
        sharded_conv2d_3x3, spatial_sharded_forward)
    mesh = make_mesh({"sp": RANKS}, device="cpu")
    out = {"halo_conv": sharded_conv2d_3x3(
        torch.from_numpy(refs["conv_x"]), torch.from_numpy(refs["conv_k"]),
        mesh, axis="sp").numpy()}
    # whole networks, height-sharded: SimpleFCN, and AdapNet (strided
    # convs, the gather for the dilated blocks, the trainable deconvs)
    fcn_vars = from_jax_variables(refs["fcn_vars"], device="cpu")
    x = torch.from_numpy(refs["fcn_x"])
    out["fcn_score"] = spatial_sharded_forward(
        lambda ctx, inp: fcn(ctx, inp, "rgb", 4, 5, channel_factor=WIDTH)[
            "score"], fcn_vars, x, mesh, axis="sp").numpy()
    try:
        spatial_sharded_forward(lambda ctx, inp: inp, fcn_vars, x[:, :48],
                                mesh, axis="sp")
    except ValueError as error:
        out["misaligned"] = str(error)
    out["adapnet_score"] = spatial_sharded_forward(
        lambda ctx, inp: adapnet(ctx, inp, "rgb", 4, 5)["score"],
        from_jax_variables(refs["adapnet_vars"], device="cpu"),
        torch.from_numpy(refs["adapnet_x"]), mesh, axis="sp").numpy()
    # one SGD(1.0) train step with train-mode batch norm, sharded and
    # not, then the eval step
    batch = refs["sp_batch"]
    steps = {}
    for kind in ("unsharded", "sharded"):
        net = _port_model("simple_fcn", refs["sp_vars"],
                          refs["sp_description"], sgd=True, **SP_KWARGS)
        if kind == "sharded":
            distribute_spatial(net, mesh, axis="sp")
        new, _, loss = net._train_step(net.variables, net.opt_state, batch)
        steps[kind] = (float(loss), {k: (new[k] - net.variables[k]).numpy()
                                     for k in net.variables})
        # both evaluate the unsharded step's variables
        if kind == "unsharded":
            evaluated = new
        net.variables = evaluated
        steps[kind + "_eval"] = {
            k: v.numpy() for k, v in net._eval_step(
                net._batch_to_device(batch)).items()
            if k in ("prediction", "prob", "confusion_matrix")}
    out["sp_steps"] = steps
    try:
        net = _port_model("simple_fcn", refs["sp_vars"],
                          refs["sp_description"], sgd=True, **SP_KWARGS)
        distribute_spatial(net, mesh, axis="sp")
        net._train_step(net.variables, net.opt_state,
                        {k: v[:, :48] for k, v in batch.items()})
    except ValueError as error:
        out["sp_misaligned"] = str(error)
    # what does not compose with a split height refuses
    out["sp_refused"] = []
    for config in ({"microbatch_size": 1},
                   {"device_augmentation": {"hflip": 0.5}}):
        net = _port_model("simple_fcn", refs["sp_vars"],
                          refs["sp_description"], sgd=True,
                          **dict(SP_KWARGS, **config))
        distribute_spatial(net, mesh, axis="sp")
        try:
            net._train_step(net.variables, net.opt_state, batch)
        except NotImplementedError as error:
            out["sp_refused"].append(str(error))
    # the Bayes fusion of two experts, height-sharded
    bayes = _port_model("bayes_mix", refs["bayes_vars"],
                        refs["sp_description"],
                        confusion_matrices=refs["bayes_cms"],
                        **BAYES_KWARGS)
    distribute_spatial(bayes, mesh, axis="sp")
    evaluated = bayes._eval_step(bayes._batch_to_device(refs["bayes_batch"]))
    out["bayes"] = {k: evaluated[k].numpy() for k in
                    ("prediction", "confusion_matrix", "rgb_prob",
                     "depth_prob")}
    return out


def rank_checks(refs):
    """The port's side of every multi-rank test, in one launch."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    out = {"rank": dist.get_rank()}
    out.update(_mesh_checks())
    out.update(_dp_checks(refs))
    out.update(_tp_checks(refs))
    out.update(_spatial_checks(refs))
    out["jax_loaded"] = "jax" in sys.modules
    return out


# ------------------------------------------------------------ the JAX side

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (see tests/test_torch_serving.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_net(name, description, **kwargs):
    from modular_semantic_segmentation_tpu.models import get_model
    return get_model(name)(data_description=description, **kwargs)


def _jax_numpy(variables):
    return {k: np.asarray(v) for k, v in variables.items()}


def _randomized_statistics(variables, rng, deconvs=False):
    """Moving statistics away from 0 and 1, so eval-mode batch norm does
    something (and the deconv kernels dense, with ``deconvs``)."""
    out = dict(variables)
    for k, v in variables.items():
        if k.endswith("moving_mean"):
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif deconvs and "upconv/kernel" in k:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return out


def _inputs():
    """Everything both sides take: the batches and JAX's initial weights
    (the models built, nothing run)."""
    import jax
    from modular_semantic_segmentation_tpu.models.adapnet import adapnet
    from modular_semantic_segmentation_tpu.models.simple_fcn import fcn
    from modular_semantic_segmentation_tpu.ops.variables import \
        init_variables
    data = _data()
    description = data.get_data_description()
    rng = np.random.RandomState(0)
    jax_nets = {
        "dp": _jax_net("simple_fcn", description, **DP_KWARGS),
        "converge": _jax_net("simple_fcn", description, **CONVERGE_KWARGS),
        "tp": _jax_net("simple_fcn", description, **TP_KWARGS),
        "tp_train": _jax_net("simple_fcn", description, **TP_TRAIN_KWARGS),
        "sp": _jax_net("simple_fcn", SP_DESCRIPTION, **SP_KWARGS)}
    conv_data = _data(num_train=16)
    batches = conv_data.get_trainset().batches(8, shuffle=True, repeat=True,
                                               seed=1)
    train_batches = data.get_trainset().batches(4, shuffle=True, repeat=True,
                                                seed=9)
    inputs = {
        "description": description,
        "batch": _batch(next(data.get_trainset().batches(8, shuffle=True,
                                                         seed=0))),
        "test": _batch(next(data.get_testset().batches(4))),
        "tp_batch": _batch(next(data.get_testset().batches(2))),
        "tp_train_batches": [_batch(next(train_batches)) for _ in range(2)],
        "converge": {"batches": [_batch(next(batches)) for _ in range(20)],
                     "vars": _jax_numpy(jax_nets["converge"].variables)},
        "dp_vars": _jax_numpy(jax_nets["dp"].variables),
        "tp_vars": _jax_numpy(jax_nets["tp"].variables),
        "tp_train_vars": _jax_numpy(jax_nets["tp_train"].variables),
        "sp_description": SP_DESCRIPTION,
        "sp_vars": _jax_numpy(jax_nets["sp"].variables),
        "conv_x": rng.randn(2, 32, 16, 3).astype(np.float32),
        "conv_k": rng.randn(3, 3, 3, 4).astype(np.float32),
        "fcn_x": rng.rand(1, 64, 64, 3).astype(np.float32),
        "adapnet_x": rng.rand(1, 64, 32, 3).astype(np.float32),
        "sp_batch": {
            "rgb": (rng.rand(1, 64, 32, 3) * 255).astype(np.float32),
            "labels": rng.randint(-1, 5, (1, 64, 32)).astype(np.int32)},
        "bayes_cms": {m: rng.rand(5, 5) + np.eye(5) * 5
                      for m in ("rgb", "depth")},
        "bayes_batch": {
            "rgb": (rng.rand(1, 64, 32, 3) * 255).astype(np.float32),
            "depth": rng.rand(1, 64, 32, 1).astype(np.float32),
            "labels": rng.randint(-1, 5, (1, 64, 32)).astype(np.int32)}}
    key = jax.random.PRNGKey(1)
    fcn_vars, _ = init_variables(
        lambda ctx, inp: fcn(ctx, inp, "rgb", 4, 5, channel_factor=WIDTH)[
            "score"], key, inputs["fcn_x"])
    inputs["fcn_vars"] = _randomized_statistics(_jax_numpy(fcn_vars), rng)
    adapnet_vars, _ = init_variables(
        lambda ctx, inp: adapnet(ctx, inp, "rgb", 4, 5)["score"], key,
        inputs["adapnet_x"])
    inputs["adapnet_vars"] = _randomized_statistics(
        _jax_numpy(adapnet_vars), rng, deconvs=True)
    jax_nets["bayes"] = _jax_net("bayes_mix", SP_DESCRIPTION,
                                 confusion_matrices=inputs["bayes_cms"],
                                 **BAYES_KWARGS)
    inputs["bayes_vars"] = _jax_numpy(jax_nets["bayes"].variables)
    return inputs, jax_nets


def _jax_refs(inputs, nets):
    """JAX's outputs for the same inputs."""
    import jax
    import optax
    from modular_semantic_segmentation_tpu.models.adapnet import adapnet
    from modular_semantic_segmentation_tpu.models.simple_fcn import fcn
    from modular_semantic_segmentation_tpu.ops.variables import (
        Ctx, split_trainable)
    from modular_semantic_segmentation_tpu.parallel import make_mesh
    from modular_semantic_segmentation_tpu.parallel.spatial import \
        sharded_conv2d_3x3
    description = inputs["description"]
    refs = {}
    # the global gradient of the data-parallel test (batch norm off)
    single = nets["dp"]
    tvars, fvars = split_trainable(single.variables, single.trainable)
    rng = jax.random.PRNGKey(42)

    def loss_fn(tvars, batch):
        onehot = jax.nn.one_hot(batch["labels"], description[2])
        ctx = Ctx({**fvars, **tvars}, train=True, rng=rng)
        return single._train_outputs(ctx, dict(batch, labels=onehot))["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tvars,
                                                       inputs["batch"])
    refs.update(dp_loss=float(loss), dp_grads=_jax_numpy(grads),
                dp_prob=single.predict(inputs["test"], output_attr="prob"))
    # 20 steps with batch norm: JAX's first step gives the loss
    converge = nets["converge"]
    _, _, first = converge._train_step(
        converge.variables, converge.opt_state,
        inputs["converge"]["batches"][0], jax.random.PRNGKey(0))
    refs["converge_first_loss"] = float(first)
    # tensor parallelism: eval, then two adam steps
    refs["tp_prob"] = nets["tp"].predict(inputs["tp_batch"],
                                         output_attr="prob")
    tp_train, losses = nets["tp_train"], []
    for step, step_batch in enumerate(inputs["tp_train_batches"]):
        tp_train.variables, tp_train.opt_state, loss = \
            tp_train._jit_train_step(tp_train.variables, tp_train.opt_state,
                                     step_batch, jax.random.PRNGKey(step))
        losses.append(float(loss))
    refs["tp_train_losses"] = losses
    refs["tp_train_kernel"] = np.asarray(
        tp_train.variables["rgb/conv1_1/kernel"])
    # spatial: the halo conv sharded on JAX's 8-device mesh, the networks
    # and the steps unsharded
    refs["halo_conv"] = np.asarray(sharded_conv2d_3x3(
        inputs["conv_x"], inputs["conv_k"], make_mesh({"data": 8}),
        axis="data"))
    refs["fcn_score"] = np.asarray(fcn(
        Ctx(inputs["fcn_vars"], train=False), inputs["fcn_x"], "rgb", 4, 5,
        channel_factor=WIDTH)["score"])
    refs["adapnet_score"] = np.asarray(adapnet(
        Ctx(inputs["adapnet_vars"], train=False), inputs["adapnet_x"], "rgb",
        4, 5)["score"])
    sp = nets["sp"]
    sp._optimizer = optax.sgd(1.0)
    sp.opt_state = sp._optimizer.init(split_trainable(sp.variables,
                                                      sp.trainable)[0])
    new, _, loss = jax.jit(sp._train_step)(
        sp.variables, sp.opt_state, inputs["sp_batch"],
        jax.random.PRNGKey(11))
    refs["sp_loss"] = float(loss)
    refs["sp_delta"] = {k: np.asarray(new[k]) - np.asarray(v)
                        for k, v in sp.variables.items()}
    bayes = nets["bayes"]
    out = bayes._jit_eval_step(bayes.variables, inputs["bayes_batch"],
                               jax.random.PRNGKey(4))
    refs["bayes"] = {k: np.asarray(out[k]) for k in
                     ("prediction", "confusion_matrix", "rgb_prob",
                      "depth_prob")}
    return refs


@pytest.fixture(scope="module")
def run():
    """(inputs, JAX's references, the ranks' results): the ranks run
    while JAX computes its references."""
    inputs, nets = _inputs()
    box = {}

    def ranks():
        try:
            box["ranks"] = launch(rank_checks, RANKS, args=(inputs,),
                                  backend="gloo", device="cpu")
        except Exception as error:  # re-raised below, in the test
            box["error"] = error

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = _jax_refs(inputs, nets)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    results = box["ranks"]
    assert [r["rank"] for r in results] == list(range(RANKS))
    assert not any(r["jax_loaded"] for r in results)
    return inputs, refs, results


@pytest.fixture(scope="module")
def ranks(run):
    return run[2]


@pytest.fixture(scope="module")
def jax_refs(run):
    inputs, refs, _ = run
    return {**inputs, **refs}


# ------------------------------------------------------------------ tests

def test_mesh_creation(ranks):
    import jax
    from modular_semantic_segmentation_tpu.parallel import make_mesh
    devices = jax.devices()[:RANKS]
    assert ranks[0]["mesh"] == make_mesh({"data": 2, "expert": 2},
                                         devices=devices).shape
    with pytest.raises(ValueError) as error:
        make_mesh({"data": 3}, devices=devices)
    assert all(r["mesh_error"] == str(error.value) for r in ranks)


def test_multislice_dcn_mesh_topology_and_psum(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from modular_semantic_segmentation_tpu.parallel import \
        make_multislice_mesh
    mesh = make_multislice_mesh(num_slices=2, ici_axes={"data": 2},
                                devices=jax.devices()[:RANKS])
    total = jax.shard_map(
        lambda v: jax.lax.psum(v, ("slice", "data")), mesh=mesh,
        in_specs=P(("slice", "data")), out_specs=P())(jnp.arange(4.0))
    assert all(r["multislice"] == mesh.shape for r in ranks)
    assert all(r["psum"] == float(total[0]) == 6.0 for r in ranks)
    # slice-major, as JAX lays the mesh out
    assert [r["slice_order"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    with pytest.raises(ValueError) as error:
        make_multislice_mesh(num_slices=3, devices=jax.devices()[:RANKS])
    assert all(r["multislice_error"] == str(error.value) for r in ranks)


def test_data_parallel_training_matches_single_device(ranks, jax_refs):
    for r in ranks:
        assert r["dp_loss"] == pytest.approx(jax_refs["dp_loss"], rel=1e-5)
        for k, grad in jax_refs["dp_grads"].items():
            assert _scaled_error(-r["dp_delta"][k], grad) <= 1e-3, k
        assert np.isfinite(r["dp_adam_loss"])
    # the eval path after the step: every rank gathers the same outputs,
    # and the summed kernel-A counts are those of the gathered labels
    first = ranks[0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["dp_prediction"],
                                      first["dp_prediction"])
        np.testing.assert_array_equal(r["dp_score"], first["dp_score"])
    from modular_semantic_segmentation_torch.ops.cuda.confusion import \
        confusion_counts_plain
    labels = jax_refs["test"]["labels"]
    counts = confusion_counts_plain(
        torch.from_numpy(first["dp_prediction"]), torch.from_numpy(labels),
        jax_refs["description"][2]).numpy()
    np.testing.assert_array_equal(first["dp_score"], counts)
    assert first["dp_prob"].shape == jax_refs["dp_prob"].shape


def test_data_parallel_microbatch_matches_full_batch(ranks, jax_refs):
    for r in ranks:
        assert r["micro_loss"] == pytest.approx(jax_refs["dp_loss"],
                                                rel=1e-5)
        for k, grad in jax_refs["dp_grads"].items():
            assert _scaled_error(-r["micro_delta"][k], grad) <= 1e-3, k


def test_data_parallel_training_converges(ranks, jax_refs):
    losses = ranks[0]["converge_losses"]
    assert losses[0] == pytest.approx(jax_refs["converge_first_loss"],
                                      rel=1e-5)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
    # the replicas stay in sync, bit for bit
    for r in ranks[1:]:
        assert r["converge_losses"] == losses
        for k, v in ranks[0]["converge_vars"].items():
            np.testing.assert_array_equal(r["converge_vars"][k], v,
                                          err_msg=k)
    assert np.isfinite(ranks[0]["converge_score"])


def test_multislice_dcn_mesh_training(ranks, jax_refs):
    for r in ranks:
        (floss, fkernel), (hloss, hkernel) = (r["multislice_steps"]["flat"],
                                              r["multislice_steps"]["hybrid"])
        assert floss == pytest.approx(jax_refs["converge_first_loss"],
                                      rel=1e-5)
        assert hloss == pytest.approx(floss, rel=1e-4)
        np.testing.assert_allclose(hkernel, fkernel, rtol=1e-4, atol=1e-6)


def test_tensor_parallel_eval_matches_replicated(ranks, jax_refs):
    for r in ranks:
        # the kernels really are channel shards: half the output channels
        full = jax_refs["tp_vars"]["rgb/conv2_1/kernel"].shape
        assert r["tp_shapes"]["rgb/conv2_1/kernel"] == full[:3] + (
            full[3] // 2,)
        assert r["tp_spec"] == (None, None, None, "model")
        # a per-channel vector shards, a [1, 1, 4, K] kernel of K = 4 too
        assert r["tp_shapes"]["rgb/conv2_1/bias"] == (full[3] // 2,)
        np.testing.assert_allclose(r["tp_prob"], jax_refs["tp_prob"],
                                   rtol=0, atol=1e-5)


def test_tensor_parallel_train_matches_single_device(ranks, jax_refs):
    for r in ranks:
        for got, want in zip(r["tp_train_losses"],
                             jax_refs["tp_train_losses"]):
            assert got == pytest.approx(want, rel=1e-3)
        # JAX's own gate for this two-step adam trajectory (its test's
        # note: adam rescales reduction-order noise per element)
        want = jax_refs["tp_train_kernel"]
        block = want.shape[-1] // 2
        want = want[..., r["tp_model_index"] * block:][..., :block]
        diff = np.abs(r["tp_train_kernel"] - want)
        assert diff.max() < 5e-3 and diff.mean() < 1e-4, diff.max()
        full = jax_refs["tp_vars"]["rgb/conv2_1/kernel"].shape
        assert r["tp_train_shape"] == full[:3] + (full[3] // 2,)
        assert r["tp_opt_shape"] == r["tp_train_shape"]


def test_rejit_preserves_tensor_parallel_shardings(ranks, jax_refs):
    for r in ranks:
        assert r["tp_dequantized_shape"] == r["tp_shapes"][
            "rgb/conv2_1/kernel"]
        np.testing.assert_array_equal(r["tp_dequantized_prob"],
                                      r["tp_prob"])
        np.testing.assert_allclose(r["tp_dequantized_prob"],
                                   jax_refs["tp_prob"], rtol=0, atol=1e-5)
        # the int8 path ran on the shards, and differs from float
        assert not np.array_equal(r["tp_int8_prob"], r["tp_prob"])
        np.testing.assert_allclose(r["tp_int8_prob"], r["tp_prob"], atol=0.1)


def test_pipeline_parallel_fcn_matches_single_program():
    from modular_semantic_segmentation_tpu.parallel.pipeline import \
        fcn_inference_pipeline as jax_pipeline
    from modular_semantic_segmentation_torch.parallel import \
        fcn_inference_pipeline
    data = _data()
    description = data.get_data_description()
    # full width: JAX's pipeline stages build the expert at width 1.0
    kwargs = dict(prefix="rgb", modality="rgb", num_units=4, batchsize=1,
                  seed=13)
    jnet = _jax_net("simple_fcn", description, **kwargs)
    net = _port_model("simple_fcn", _jax_numpy(jnet.variables), description,
                      **kwargs)
    batch = _batch(next(data.get_testset().batches(4)))
    microbatches = [{"rgb": batch["rgb"][i:i + 1]} for i in range(4)]
    got = fcn_inference_pipeline(net, devices=["cpu", "cpu"])(microbatches)
    np.testing.assert_array_equal(got, net.predict({"rgb": batch["rgb"]}))
    import jax
    want = jax_pipeline(jnet, devices=jax.devices()[:2])(microbatches)
    prob = net.predict({"rgb": batch["rgb"]}, output_attr="prob")
    ok, _ = _ties_ok(got, want, prob)
    assert ok


def test_expert_parallel_dispatch():
    from modular_semantic_segmentation_tpu.parallel.expert_parallel import \
        dispatch_experts as jax_dispatch
    from modular_semantic_segmentation_torch.parallel import \
        dispatch_experts
    data = _data()
    description = data.get_data_description()
    jnet = _jax_net("average", description, **FUSION_KWARGS)
    net = _port_model("average", _jax_numpy(jnet.variables), description,
                      **FUSION_KWARGS)
    batch = _batch(next(data.get_testset().batches(2)))
    outputs = dispatch_experts(net, batch, devices=["cpu", "cpu"])
    assert set(outputs) == {"rgb", "depth"}
    assert outputs["rgb"]["prob"].shape == (2, 32, 32, 4)
    # the fused single-program expert output, and JAX's dispatch
    for m in ("rgb", "depth"):
        np.testing.assert_array_equal(
            outputs[m]["prob"], net.predict(batch, output_attr=f"{m}_prob"))
    import jax
    want = jax_dispatch(jnet, batch, devices=jax.devices()[:2])
    for m in ("rgb", "depth"):
        np.testing.assert_allclose(outputs[m]["prob"], want[m]["prob"],
                                   rtol=0, atol=1e-5)
        ok, _ = _ties_ok(outputs[m]["classification"],
                         want[m]["classification"], want[m]["prob"])
        assert ok


def test_spatial_halo_conv_matches_full_conv(ranks, jax_refs):
    # JAX's halo conv on 8 shards of 4 rows, the port's on 4 of 8
    for r in ranks:
        np.testing.assert_allclose(r["halo_conv"], jax_refs["halo_conv"],
                                   rtol=1e-5, atol=1e-5)


def test_spatial_sharded_simple_fcn_matches_unsharded(ranks, jax_refs):
    want = jax_refs["fcn_score"]
    scale = float(np.abs(want).max())
    for r in ranks:
        np.testing.assert_allclose(r["fcn_score"] / scale, want / scale,
                                   rtol=0, atol=1e-5)
        assert r["misaligned"] == "height 48 not divisible by 4 shards * 16"


def test_spatial_sharded_adapnet_matches_unsharded(ranks, jax_refs):
    # 4 shards of 16 rows: the 1/16-resolution blocks hold 1 row, so the
    # dilated blocks gather the feature map
    want = jax_refs["adapnet_score"]
    scale = float(np.abs(want).max())
    for r in ranks:
        np.testing.assert_allclose(r["adapnet_score"] / scale, want / scale,
                                   rtol=0, atol=1e-5)


def test_distribute_spatial_training_matches_unsharded(ranks, jax_refs):
    """One SGD(1.0) step with train-mode batch norm (halo convs, summed
    statistics and loss, averaged gradients) against the unsharded step:
    the port's, and JAX's."""
    for r in ranks:
        (loss, delta), (plain_loss, plain_delta) = (
            r["sp_steps"]["sharded"], r["sp_steps"]["unsharded"])
        assert loss == pytest.approx(plain_loss, rel=1e-5)
        assert loss == pytest.approx(jax_refs["sp_loss"], rel=1e-5)
        for k, want in plain_delta.items():
            assert _scaled_error(delta[k], want) <= 1e-3, k
            assert _scaled_error(delta[k], jax_refs["sp_delta"][k]) <= 1e-3, k
        # eval after the step: the ranks' summed counts are those of the
        # gathered labels, which are the unsharded labels up to near ties
        sharded, plain = (r["sp_steps"]["sharded_eval"],
                          r["sp_steps"]["unsharded_eval"])
        np.testing.assert_array_equal(sharded["confusion_matrix"],
                                      _counts(sharded["prediction"],
                                              jax_refs["sp_batch"]["labels"]))
        ok, _ = _ties_ok(sharded["prediction"], plain["prediction"],
                         plain["prob"])
        assert ok
        assert r["sp_misaligned"] == "height 48 not divisible by 4 shards * 16"
        assert len(r["sp_refused"]) == 2, r["sp_refused"]


def test_distribute_spatial_fused_inference_matches_unsharded(ranks,
                                                              jax_refs):
    want = jax_refs["bayes"]
    labels = jax_refs["bayes_batch"]["labels"]
    for r in ranks:
        got = r["bayes"]
        for m in ("rgb", "depth"):
            np.testing.assert_allclose(got[f"{m}_prob"], want[f"{m}_prob"],
                                       rtol=0, atol=1e-5)
        # the fusion is per pixel: equal labels wherever both experts'
        # labels are clear of near ties
        clear = np.ones(labels.shape, bool)
        for m in ("rgb", "depth"):
            top2 = np.sort(want[f"{m}_prob"], axis=-1)[..., -2:]
            clear &= (top2[..., 1] - top2[..., 0]) > 1e-5
        np.testing.assert_array_equal(got["prediction"][clear],
                                      want["prediction"][clear])
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(got["confusion_matrix"],
                                      _counts(got["prediction"], labels))
