"""Guards of what the GPU machine needs from the port and chip_smoke.py.

That machine has PyTorch, numpy and scipy but no JAX and none of the JAX
package's host dependencies (cv2, PIL, sklearn, yaml, pandas, tqdm). The
port, its experiment CLIs, datasets (the file drivers, the PNG reader and
the native host ops among them) and settings, and ``chip_smoke.py`` must
import without them (the experiment surface and the input pipeline run
without them), name none of them in an import, and load no module
of the JAX package; ``chip_smoke.py`` must fail, and print no
result line, where there is no CUDA card or no repository around it.
"""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

import modular_semantic_segmentation_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")
UNAVAILABLE = ("jax", "jaxlib", "cv2", "PIL", "sklearn", "yaml", "pandas",
               "tqdm")


def _port_modules():
    package = modular_semantic_segmentation_torch
    return [package.__name__] + [
        info.name for info in pkgutil.walk_packages(
            package.__path__, prefix=package.__name__ + ".")]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _forbidden(name):
    top = name.split(".")[0]
    return top in UNAVAILABLE or top == "modular_semantic_segmentation_tpu"


def test_port_imports_without_jax_and_its_host_deps():
    modules = _port_modules()
    assert len(modules) > 15
    # the experiment layer and the host data layer among them
    package = modular_semantic_segmentation_torch.__name__
    for name in ("settings", "utils.experiment", "utils.sacred_shim",
                 "utils.data_io", "ops.device_augment",
                 "datasets", "datasets.data_baseclass",
                 "datasets.unittest_data", "datasets.image_io",
                 "datasets.native_backend", "datasets.augmentation",
                 "datasets.synthia", "datasets.raw_synthia",
                 "datasets.synthia_rand", "datasets.synthia_cityscapes",
                 "datasets.cityscapes", "datasets.cityscapes_a",
                 "datasets.cityscapes_b", "datasets.toydata",
                 "datasets.mixed_data", "experiments.training",
                 "experiments.evaluation", "experiments.bayes_fusion",
                 "experiments.dirichlet_fusion",
                 "experiments.different_evaluation_parameters",
                 "experiments.timing", "experiments.uncertainty_eval",
                 "experiments.finetuning",
                 "experiments.train_and_evaluate_progressive",
                 "experiments.ibcc_fusion", "experiments.report",
                 "experiments.rerun", "datasets.not_cityscapes",
                 "utils.profiling", "ops"):
        assert f"{package}.{name}" in modules, name
    script = (
        "import sys\n"
        f"for name in {UNAVAILABLE!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] == 'modular_semantic_segmentation_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")


def test_importing_the_clis_writes_nothing(tmp_path):
    """The CLI modules make their experiments and observers when they are
    imported, and touch no file until a run starts."""
    script = (
        "from modular_semantic_segmentation_torch.experiments import (\n"
        "    bayes_fusion, different_evaluation_parameters,\n"
        "    dirichlet_fusion, evaluation, finetuning, ibcc_fusion,\n"
        "    report, rerun, timing, train_and_evaluate_progressive,\n"
        "    training, uncertainty_eval)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("EXPERIMENT_STORAGE_FOLDER", "EXP_OUT",
                        "DATA_BASEPATH")}
    env["HOME"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert os.listdir(tmp_path) == []


def test_port_sources_import_no_jax():
    package_dir = os.path.dirname(modular_semantic_segmentation_torch.__file__)
    for root, _, files in os.walk(package_dir):
        for name in files:
            if name.endswith(".py"):
                bad = sorted(filter(_forbidden, _imports(
                    os.path.join(root, name))))
                assert not bad, f"{name} imports {bad}"


def test_input_pipeline_runs_without_cv2_pil_sklearn_yaml(tmp_path):
    """The file drivers, the PNG reader and writer, the native host ops
    and the cv2 parts of host augmentation run in a process where cv2,
    PIL, sklearn and yaml cannot be imported: a raw SYNTHIA frame written
    and preprocessed by the port, its blob read, augmented with scale,
    rotate and shear, and batched."""
    script = (
        "import sys\n"
        "for name in ('cv2', 'PIL', 'sklearn', 'yaml', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "import os, random\n"
        "import numpy as np\n"
        "from modular_semantic_segmentation_torch.datasets import (\n"
        "    augmentation, get_dataset, image_io)\n"
        f"base = {str(tmp_path)!r}\n"
        "seq = os.path.join(base, 'SYNTHIA-SEQS-04-DAWN')\n"
        "rng = np.random.RandomState(0)\n"
        "for i in range(6):\n"
        "    for sub, img in (\n"
        "            ('RGB', rng.randint(0, 256, (760, 1280, 3))),\n"
        "            ('Depth', rng.randint(0, 9, (760, 1280))),\n"
        "            ('GT/LABELS', rng.randint(0, 14, (760, 1280, 3)))):\n"
        "        d = os.path.join(seq, sub, 'Stereo_Right', 'Omni_F')\n"
        "        os.makedirs(d, exist_ok=True)\n"
        "        image_io.imwrite(os.path.join(d, f'{i:06d}.png'),\n"
        "                         img.astype(np.uint8))\n"
        "data = get_dataset('synthia')(seqs=['SYNTHIA-SEQS-04-DAWN'],\n"
        "                              base_path=base)\n"
        "blob = data.get_testset().get_blob(0)\n"
        "assert blob['rgb'].shape == (368, 640, 3)\n"
        "random.seed(0)\n"
        "np.random.seed(0)\n"
        "small = {'rgb': blob['rgb'].astype(np.uint8),\n"
        "         'labels': blob['labels'].astype(np.uint8)}\n"
        "out = augmentation.augmentate(small, crop=(1.0, 96),\n"
        "    scale=(1.0, 0.7, 1.5), rotate=(1.0, -13, 13),\n"
        "    shear=(1.0, 0.05, 0.1))\n"
        "assert out['rgb'].shape == (96, 96, 3)\n"
        "batch = next(data.get_trainset().batches(2, workers=2))\n"
        "assert batch['rgb'].shape == (2, 368, 640, 3)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_experiment_surface_runs_without_host_deps(tmp_path):
    """The timing CLI (a single-model command, the serving group, a train
    step), its Table V report, the uncertainty benchmark on
    AddRandomObjects (an object library written by the port), ibcc_fusion
    and the max unpooling run in a process where jax, pandas, yaml,
    sklearn, cv2 and PIL cannot be imported."""
    script = (
        "import sys\n"
        "for name in ('jax', 'pandas', 'yaml', 'sklearn', 'cv2', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import os\n"
        "import numpy as np, torch\n"
        "from modular_semantic_segmentation_torch import ops, settings\n"
        "from modular_semantic_segmentation_torch.datasets import image_io\n"
        "from modular_semantic_segmentation_torch.experiments import (\n"
        "    ibcc_fusion, report, timing, uncertainty_eval)\n"
        "from modular_semantic_segmentation_torch.models import get_model\n"
        f"base = {str(tmp_path)!r}\n"
        "settings.EXPERIMENT_STORAGE_FOLDER = os.path.join(base, 'runs')\n"
        "settings.DATA_BASEPATH = base\n"
        "small = {'num_units': 2, 'num_classes': 4, 'repetitions': 1,\n"
        "         'compute_dtype': 'float32', 'height': 32, 'width': 32,\n"
        "         'device': 'cpu'}\n"
        "timing.ex.run('time_rgb_fcn', config_updates=small)\n"
        "timing.ex.run('time_serving', config_updates=dict(small,\n"
        "    unroll=2))\n"
        "serving = timing.ex.current_run._id\n"
        "timing.ex.run('time_train_step', config_updates=dict(small,\n"
        "    model='simple_fcn'))\n"
        "assert timing.ex.current_run.info['timings']['train_step']\n"
        "table = report.build_timing_table(serving)\n"
        "assert table.index == ['serving_bayes_fcn'], table.index\n"
        "for num in (251, 252, 253):\n"
        "    d = os.path.join(base, 'amsterdam_object_lib', str(num))\n"
        "    os.makedirs(d)\n"
        "    obj = np.zeros((10, 12, 3), np.uint8)\n"
        "    obj[2:8, 2:10] = num - 150\n"
        "    image_io.imwrite(os.path.join(d, f'{num}_c.png'), obj)\n"
        "net = dict(prefix='rgb', modality='rgb', num_units=2,\n"
        "           channel_factor=0.125, num_samples=2, dropout_rate=0.5)\n"
        "model = get_model('bayesian_fcn')(data_description=(\n"
        "    {'rgb': np.float32, 'labels': np.int32},\n"
        "    {'rgb': (None, None, 3), 'labels': (None, None)}, 4),\n"
        "    device='cpu', **net)\n"
        "weights = model.export_weights(base)\n"
        "data = {'name': 'unittest', 'height': 32, 'width': 32,\n"
        "        'num_test': 2}\n"
        "uncertainty_eval.ex.run('main', config_updates={\n"
        "    'modelname': 'bayesian_fcn', 'net_config': net,\n"
        "    'starting_weights': weights, 'device': 'cpu',\n"
        "    'benchmark': 'out_of_distribution',\n"
        "    'uncertainty_metrics': ['entropy', 'variance'],\n"
        "    'dataset': dict(data, name='add_random_objects',\n"
        "                    add_to_dataset='unittest', num_classes=4)})\n"
        "auroc = uncertainty_eval.ex.current_run.info['measurements']\n"
        "assert 0 <= auroc['entropy']['AUROC'] <= 1, auroc\n"
        "ibcc_fusion.ex.run('main', config_updates={\n"
        "    'net_config': {'expert_model': 'fcn', 'num_units': 2,\n"
        "                   'channel_factor': 0.125,\n"
        "                   'prefixes': {'rgb': 'rgb'}},\n"
        "    'dataset': data, 'starting_weights': {'rgb': weights},\n"
        "    'save_to': os.path.join(base, 'ibcc'), 'device': 'cpu'})\n"
        "x = torch.rand(1, 4, 4, 2)\n"
        "pooled, idx = ops.max_pool_with_argmax(x)\n"
        "assert ops.unpool_2d(pooled, idx).shape == x.shape\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_every_kernel_source_is_built():
    """``build()`` (which chip_smoke.py runs) compiles every ``csrc/*.cu``,
    the stem conv of the probe path among them, and each wrapper's
    library is one of them."""
    from modular_semantic_segmentation_torch.ops.cuda import (
        build, confusion, dirichlet, stem_conv)
    sources = sorted(name[:-3] for name in os.listdir(build.CSRC_DIR)
                     if name.endswith(".cu"))
    assert sorted(build.KERNEL_SOURCES) == sources
    assert "stem_conv" in sources
    for module in (confusion, dirichlet, stem_conv):
        assert module.KERNEL.source in sources


def test_chip_smoke_imports_no_jax():
    imports = _imports(SMOKE)
    assert "torch" in imports
    assert not sorted(filter(_forbidden, imports))


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="-1")
    return subprocess.run([sys.executable, SMOKE if cwd == REPO
                           else os.path.join(cwd, "chip_smoke.py")],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_failed_without_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            assert "ok" not in json.loads(line), line


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    _assert_failed_without_result(out)
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    _assert_failed_without_result(_run_smoke(str(tmp_path)))


def test_models_refuse_cuda_without_a_card():
    """device='cuda' (the default) raises here instead of running on the
    CPU."""
    import numpy as np
    import torch
    from modular_semantic_segmentation_torch.models import get_model
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    description = ({"rgb": np.float32},
                   {"rgb": (None, None, 3), "labels": (None, None)}, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        get_model("fcn")(prefix="rgb", modality="rgb",
                         data_description=description, num_units=2,
                         channel_factor=0.125)
