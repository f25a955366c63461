"""The port imports neither JAX nor the JAX package: importing every module
of `jpgenc_tpu_torch` and running CPU encodes (colour, gray, optimize) and
decodes of their files (one file, a batch, the float64 reference) leaves `jax` and `jpgenc_tpu` out of sys.modules (checked in a fresh
interpreter, since this test process imports both), and no source file of
the port or of chip_smoke.py names either in an import."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import numpy as np
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


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "jpgenc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"jpgenc_tpu_torch/decoder.py", "jpgenc_tpu_torch/ref/decoder.py",
            "jpgenc_tpu_torch/ops/cuda/recon.py",
            "jpgenc_tpu_torch/utils/metrics.py",
            "jpgenc_tpu_torch/utils/lru.py"} <= names
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
