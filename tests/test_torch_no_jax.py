"""The port stands alone: nothing under forest_tpu_torch/, chip_smoke.py nor
the port's examples (examples/torch_*.py) imports jax, flax, optax or the
JAX package forest_tpu, nor scikit-learn or
ml_dtypes (JAX's bfloat16 for numpy; the compact wire, data/wire.py, rounds
to bfloat16 with torch), which the card's machine does not have; matplotlib,
which it does not have either, is imported only inside the functions that
draw a figure. Nothing under forest_tpu_torch/ imports PIL (the port reads
and writes GeoTIFF with its own codec, data/tiff.py); chip_smoke.py imports
it only inside the function that reports whether it imports on the machine.

A static scan of every source file for import statements, and a subprocess
that imports every module of the port with those names (and matplotlib)
blocked in ``sys.modules`` (an import of a blocked name raises ImportError
there).
"""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "forest_tpu", "sklearn",
           "ml_dtypes")
# never imported by the package itself
PACKAGE_BLOCKED = BLOCKED + ("PIL",)
# imported only inside a function, never when a module is imported
LAZY = ("matplotlib", "PIL")
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = sorted((ROOT / "forest_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_op_timing.py"] \
    + EXAMPLES
LAUNCHER = ROOT / "scripts" / "train_gpu.sh"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_of_jax(path):
    blocked = PACKAGE_BLOCKED if path.name != "chip_smoke.py" else BLOCKED
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in blocked]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_matplotlib_only_inside_functions(path):
    tree = ast.parse(path.read_text(), str(path))
    top = [node for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))]
    bad = [node.lineno for node in top
           for name in ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
           if (name or "").split(".")[0] in LAZY]
    assert not bad, (f"{path.relative_to(ROOT)} imports matplotlib or PIL "
                     f"at {bad}")


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("forest_tpu_torch/serving.py",
                 "forest_tpu_torch/data/bindings.py",
                 "forest_tpu_torch/data/cube_v2.py",
                 "forest_tpu_torch/data/frl_dataset.py",
                 "forest_tpu_torch/data/blosc1.py",
                 "forest_tpu_torch/ops/scatter.py",
                 "forest_tpu_torch/training/representation/step.py",
                 "forest_tpu_torch/training/representation/train_step.py",
                 "forest_tpu_torch/training/representation/loops.py",
                 "forest_tpu_torch/training/train_representation.py",
                 "forest_tpu_torch/data/stats.py",
                 "forest_tpu_torch/ops/vq.py",
                 "forest_tpu_torch/ops/vq_variants.py",
                 "forest_tpu_torch/models/vqvae.py",
                 "forest_tpu_torch/training/vqvae_step.py",
                 "forest_tpu_torch/training/train_vqvae.py",
                 "forest_tpu_torch/training/annealers.py",
                 "forest_tpu_torch/data/cube.py",
                 "forest_tpu_torch/data/vqvae_dataset.py",
                 "forest_tpu_torch/data/loader.py",
                 "forest_tpu_torch/eval/export_codebook.py",
                 "forest_tpu_torch/eval/frozen.py",
                 "forest_tpu_torch/eval/linear_probe.py",
                 "forest_tpu_torch/eval/train_probe.py",
                 "forest_tpu_torch/eval/phase_probe.py",
                 "forest_tpu_torch/eval/embed_locations.py",
                 "forest_tpu_torch/eval/export_embeddings.py",
                 "forest_tpu_torch/models/heads.py",
                 "forest_tpu_torch/losses/phase_pairs.py",
                 "forest_tpu_torch/losses/soft_neighborhood.py",
                 "forest_tpu_torch/losses/phase_neighborhood.py",
                 "forest_tpu_torch/losses/triplet_phase.py",
                 "forest_tpu_torch/losses/evt_soft_neighborhood.py",
                 "forest_tpu_torch/training/representation/diagnostics.py",
                 "forest_tpu_torch/eval/cluster.py",
                 "forest_tpu_torch/eval/gmm.py",
                 "forest_tpu_torch/eval/landscape_categories.py",
                 "forest_tpu_torch/eval/fia.py",
                 "forest_tpu_torch/eval/tau_calibration.py",
                 "forest_tpu_torch/utils/log.py",
                 "forest_tpu_torch/eval/phase_diagnostics.py",
                 "forest_tpu_torch/eval/visualize.py",
                 "forest_tpu_torch/utils/torch_import.py",
                 "forest_tpu_torch/data/io.py",
                 "forest_tpu_torch/data/tiff.py",
                 "forest_tpu_torch/data/raster.py",
                 "forest_tpu_torch/data/vrt.py",
                 "forest_tpu_torch/data/reproject.py",
                 "forest_tpu_torch/data/band_stats.py",
                 "forest_tpu_torch/data/zarr_builder.py",
                 "forest_tpu_torch/data/build_zarr_v2.py",
                 "forest_tpu_torch/data/zarr_info.py",
                 "forest_tpu_torch/data/manifest_stack.py",
                 "forest_tpu_torch/data/data_bundle.py",
                 "forest_tpu_torch/data/wire.py",
                 "forest_tpu_torch/utils/flops.py",
                 "forest_tpu_torch/utils/spans.py",
                 "chip_smoke.py",
                 "scripts/torch_op_timing.py",
                 "examples/torch_example_losses.py",
                 "examples/torch_example_encoders.py",
                 "examples/torch_check_evt_tau.py",
                 "examples/torch_example_compute_stats.py",
                 "examples/torch_example_dataset.py",
                 "examples/torch_example_quickstart.py"):
        assert must in names, must


def test_every_module_imports_with_jax_blocked():
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED + LAZY!r}:
    sys.modules[name] = None          # any import of it raises ImportError
sys.path.insert(0, {str(ROOT)!r})
import forest_tpu_torch
mods = ["forest_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    forest_tpu_torch.__path__, "forest_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke, runpy
for path in {[str(p) for p in EXAMPLES]!r}:
    runpy.run_path(path, run_name="port_example")
leaked = [m for m in sys.modules if m.split(".")[0] in {BLOCKED + LAZY!r}
          and sys.modules[m] is not None]
assert not leaked, leaked
assert len(mods) > 62, mods
print("imported", len(mods))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_gpu_launcher_runs_the_port():
    """scripts/train_gpu.sh parses, launches the port's CLIs and nothing of
    the JAX package, and refuses an unknown mode with exit code 2."""
    text = LAUNCHER.read_text()
    subprocess.run(["bash", "-n", str(LAUNCHER)], check=True, timeout=60)
    modules = set(re.findall(r"\b(forest_tpu\w*)\.([\w.]+)", text))
    assert {m for m in modules if m[0] == "forest_tpu_torch"} == {
        ("forest_tpu_torch", "training.train_representation"),
        ("forest_tpu_torch", "training.train_vqvae")}
    assert not [m for m in modules if m[0] != "forest_tpu_torch"], modules
    proc = subprocess.run(["bash", str(LAUNCHER), "bogus"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2, proc
    assert "unknown mode: bogus" in proc.stderr


def test_native_decoder_is_the_ports_own_and_matches_python(tmp_path):
    """The chunk decoder is built from a source inside the package, and
    decodes what the pure-Python path decodes (bit for bit)."""
    import numpy as np

    from forest_tpu_torch.data import native, zarrlite as zl

    pkg = ROOT / "forest_tpu_torch"
    assert native._SRC == pkg / "csrc" / "zarr_decode.cpp"
    assert native._SRC.is_file()
    assert native._LIB_PATH.parent == pkg / "csrc" / "build"
    if not native.available():
        pytest.skip("no C++ compiler: the pure-Python path is used")
    data = np.random.default_rng(0).normal(size=(6, 16, 16)).astype(
        np.float32)
    a = zl.create_array(tmp_path / "a", (8, 16, 16), (1, 16, 16), np.float32,
                        fill_value=float("nan"))
    a[:6] = data
    cidxs = [(i, 0, 0) for i in range(8)]
    nat = a.read_chunks_batch(cidxs, use_native=True)
    py = a.read_chunks_batch(cidxs, use_native=False)
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat[:6, 0], data)
    assert np.isnan(nat[6:]).all()
