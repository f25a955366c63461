"""The port imports neither JAX nor the JAX package: importing every module
of `jpgenc_tpu_torch` and running CPU encodes (colour, gray, optimize) and
decodes of their files (one file, a batch, the float64 reference), the
batch driver over PPM files, stripe mode, the batch-split decode and
`python -m jpgenc_tpu_torch --help`, and importing dryrun_torch.py and the
two-process test workers, leave `jax` and `jpgenc_tpu` out of sys.modules
(checked in fresh interpreters, since this test process imports both), and
no source file of the port, of bench_torch.py, chip_smoke.py,
dryrun_torch.py or the workers names either in an import."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import jpgenc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jpgenc_tpu_torch.__path__,
                                               "jpgenc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from jpgenc_tpu_torch import api
from jpgenc_tpu_torch.parallel import mesh
from jpgenc_tpu_torch.ref.decoder import exact_decode
from jpgenc_tpu_torch.utils import fixtures
rgb = fixtures.synth_frame(32, 48)
for img in (rgb, rgb[..., 1].copy()):
    for optimize in (False, True):
        data = api.encode(img, 75, optimize=optimize, device="cpu")
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        assert mesh.encode_batch(img[None], 75, optimize=optimize,
                                 device="cpu") == [data]
        px = api.decode(data, device="cpu")
        assert px.shape == img.shape and px.dtype == np.uint8
        both = api.decode_batch([data, data], chunk=1, device="cpu")
        assert all(np.array_equal(b, px) for b in both)
        assert np.abs(px.astype(int)
                      - exact_decode(data).astype(int)).max() <= 3
import os, tempfile
from jpgenc_tpu_torch import io
from jpgenc_tpu_torch.batch import run_batch
with tempfile.TemporaryDirectory() as d:
    paths = [os.path.join(d, f"{i}.ppm") for i in range(3)]
    for i, p in enumerate(paths):
        io.save(p, fixtures.synth_frame(16, 24, seed=i))
    outs = [p[:-4] + ".jpg" for p in paths]
    res = run_batch(paths, outs, os.path.join(d, "m.jsonl"), chunk_size=2,
                    device="cpu")
    assert res.done == 3
import importlib.util, pathlib
import dryrun_torch
for name in ("_torch_mp_worker", "_torch_mp_fault_worker"):
    spec = importlib.util.spec_from_file_location(
        name, pathlib.Path("tests") / (name + ".py"))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from jpgenc_tpu_torch.parallel import multihost
multihost.initialize()
assert multihost.gather_bytes(b"x") == [b"x"]
assert mesh.encode_striped(rgb, 2, device="cpu") == \
    api.encode(rgb, restart_interval=3, device="cpu")
pix = mesh.decode_batch([data] * 3, devices=["cpu"] * 2, device="cpu")
assert mesh.encode_batch(pix, devices=["cpu"] * 2, device="cpu") == \
    mesh.encode_batch(torch.cat(pix).numpy(), device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jpgenc_tpu"))
print("MODULES", len(names), "JAX", bad)
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MODULES")]
    n, jax_mods = line[0].split()[1], line[0].split("JAX", 1)[1].strip()
    assert int(n) >= 30
    assert jax_mods == "[]"


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|jpgenc_tpu)\b(?!_)", re.M)


_HELP_PROBE = r"""
import runpy, sys
sys.argv = ["jpgenc_tpu_torch", "--help"]
try:
    runpy.run_module("jpgenc_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jpgenc_tpu"))
print("JAX", bad)
"""


def test_module_help_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-m", "jpgenc_tpu_torch", "--help"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    for cmd in ("encode", "batch", "decode", "bench", "rd-curve"):
        assert cmd in r.stdout
    r = subprocess.run([sys.executable, "-c", _HELP_PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "JAX []"


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "jpgenc_tpu_torch").rglob("*.py"))
    files += [ROOT / "bench_torch.py", ROOT / "chip_smoke.py",
              ROOT / "dryrun_torch.py"]
    files += sorted((ROOT / "tests").glob("_torch_mp_*.py"))
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"jpgenc_tpu_torch/decoder.py", "jpgenc_tpu_torch/ref/decoder.py",
            "jpgenc_tpu_torch/ops/cuda/recon.py",
            "jpgenc_tpu_torch/utils/metrics.py",
            "jpgenc_tpu_torch/utils/lru.py", "jpgenc_tpu_torch/io.py",
            "jpgenc_tpu_torch/batch.py", "jpgenc_tpu_torch/cli.py",
            "jpgenc_tpu_torch/__main__.py",
            "jpgenc_tpu_torch/utils/profiling.py", "bench_torch.py",
            "chip_smoke.py", "dryrun_torch.py",
            "jpgenc_tpu_torch/parallel/multihost.py",
            "tests/_torch_mp_worker.py",
            "tests/_torch_mp_fault_worker.py"} <= names
    assert len(files) >= 31 and offenders == []


def test_import_pattern_tells_the_packages_apart():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from jpgenc_tpu import api", "import jpgenc_tpu.engine",
                 "    from jpgenc_tpu.ref import encoder"):
        assert _IMPORT.search(line), line
    for line in ("from jpgenc_tpu_torch import api", "import jpgenc_tpu_torch",
                 "import jpgenc_tpu_torch.engine", "import jaxtyping",
                 "# from jax import x is not allowed"):
        assert not _IMPORT.search(line), line
