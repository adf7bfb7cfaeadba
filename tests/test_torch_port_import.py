"""PyTorch port, import isolation: importing every module of
``schnetpack_tpu_torch`` (the data pipeline, transforms, training, datasets,
CLIs, interfaces, deploy, the ORCA calculator and the multi-rank modules
included) loads neither jax, flax, optax nor ``schnetpack_tpu``, nor do
the tests' rank workers, and ``chip_smoke.py`` imports none of them."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "schnetpack_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_module_of_the_port_leaves_jax_out():
    code = (
        "import pkgutil, sys, schnetpack_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'schnetpack_tpu_torch.')]\n"
        "for n in names: __import__(n)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + "
        f"'.') for f in {FORBIDDEN!r})]\n"
        "need = ['schnetpack_tpu_torch.' + m for m in ('data.loader', "
        "'data.datamodule', 'transform.casting', 'train.task', "
        "'train.loop', 'train.loggers', 'datasets.md17', 'cli', "
        "'md.cli', 'convert', 'interfaces.ase_interface', "
        "'interfaces.batchwise', 'interfaces.lammps.server', "
        "'interfaces.torch_import', 'deploy', 'utils.compatibility', "
        "'md.parsers.orca_parser', 'md.calculators.orca', "
        "'parallel.mesh', 'parallel.data_parallel', 'parallel.spatial', "
        "'datasets.misc')]\n"
        "print(len(names), bad, [n for n in need if n not in names])\n"
        "sys.exit(bool(bad) or any(n not in names for n in need))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_rank_workers_leave_jax_out():
    """A spawned rank imports ``tests/torch_parallel_workers.py`` by name:
    it loads none of jax, flax, optax and ``schnetpack_tpu``."""
    code = (
        "import sys, torch_parallel_workers\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + "
        f"'.') for f in {FORBIDDEN!r})]\n"
        "print(bad)\n"
        "sys.exit(bool(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_configs_name_only_the_port():
    """Every ``_target_`` (and sampler class) of the training configs
    names a class of the port."""
    from schnetpack_tpu_torch import cli
    from schnetpack_tpu_torch.config import miniyaml
    from schnetpack_tpu_torch.utils import str2class

    n = 0
    for d, _, files in os.walk(cli._PKG_CONFIG_DIR):
        for f in files:
            def walk(node):
                nonlocal n
                if isinstance(node, dict):
                    for k, v in node.items():
                        if k in ("_target_", "train_sampler_cls"):
                            assert v.startswith("schnetpack_tpu_torch."), v
                            str2class(v)
                            n += 1
                        walk(v)
                elif isinstance(node, list):
                    for v in node:
                        walk(v)
            walk(miniyaml.load(os.path.join(d, f)))
    assert n > 20


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert names and not [n for n in names if _forbidden(n)]
