"""The port's command line and checkpointed batch driver on the CPU
(device="cpu" runs each kernel's plain version): the counterparts of
tests/test_sweep_cli_batch.py's CLI and batch tests and of
tests/test_io_meshconfig.py's file-driven batch tests, and the port's CLI
files against jpgenc_tpu's CLI files.

Every image comes from a literal seed in this file. Port files are held
against the reference's under ROADMAP.md Queue 3's split assertion: the
transform within the knife-edge policy (|diff| <= 1 on at most
max(1e-4, 2/size) of the decoded coefficients), everything after it
byte-exact (the reference file's own coefficients through the port's entropy
path give the reference's file), and whole-file equality wherever no
coefficient differs.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpgenc_tpu import batch as jbatch
from jpgenc_tpu import cli as jcli
from jpgenc_tpu.container.parser import parse_jpeg
from jpgenc_tpu.layout import make_layout
from jpgenc_tpu.native import decode_scan
from jpgenc_tpu_torch import api, engine, io
from jpgenc_tpu_torch.batch import run_batch
from jpgenc_tpu_torch.cli import main as cli_main
from jpgenc_tpu_torch.config import EncodeConfig
from jpgenc_tpu_torch.parallel import mesh
from jpgenc_tpu_torch.utils.fixtures import synth_frame
from jpgenc_tpu_torch.utils.metrics import psnr

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]

torch.set_num_threads(1)


def _images(n=7, h=48, w=64, seed=42):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8)


# --- the split assertion ------------------------------------------------------

def _coefficients(data):
    p = parse_jpeg(data)
    lay = make_layout(p.height, p.width, p.subsampling, p.restart_interval)
    return p, lay, decode_scan(p.scan_data, lay, [c.dc_tab for c in p.comps],
                               [c.ac_tab for c in p.comps],
                               [p.dc_tables.get(i) for i in range(2)],
                               [p.ac_tables.get(i) for i in range(2)])


def _from_reference_coefficients(ref: bytes, quality: int, optimize: bool):
    """The reference file's coefficients through the port's entropy path on
    the CPU, up to a whole file."""
    _, lay, coef = _coefficients(ref)
    plan = engine.get_plan(lay.height, lay.width, lay.subsampling, quality,
                           "cpu", lay.restart_interval)
    zz = torch.from_numpy(coef.astype(np.int16))[None].index_select(
        1, plan.scan_gather)
    zz[:, lay.n_scan:] = 0
    return engine.EncodeJob(plan, EncodeConfig(
        quality=quality, optimize_huffman=optimize), zz=zz).file()


def _assert_split(ours: bytes, ref: bytes, quality: int, optimize=False):
    pa, _, a = _coefficients(ours)
    pb, _, b = _coefficients(ref)
    assert (pa.height, pa.width, pa.subsampling, pa.restart_interval) == \
        (pb.height, pb.width, pb.subsampling, pb.restart_interval)
    d = np.abs(a - b)
    assert d.max() <= 1
    assert (d > 0).mean() <= max(1e-4, 2.0 / d.size)
    assert _from_reference_coefficients(ref, quality, optimize) == ref
    if not d.any():
        assert ours == ref


# --- the CLI ------------------------------------------------------------------

def _run_module(*args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "jpgenc_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_module_encode_decode_roundtrip(tmp_path):
    img = synth_frame(40, 72, seed=11)
    io.save(str(tmp_path / "in.ppm"), img)
    r = _run_module("encode", "in.ppm", "out.jpg", "--quality", "85",
                    "--restart", "2", *CPU, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    data = (tmp_path / "out.jpg").read_bytes()
    assert data == api.encode(img, 85, restart_interval=2, device="cpu")
    r = _run_module("decode", "out.jpg", "back.ppm", *CPU, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    back = io.load(str(tmp_path / "back.ppm"))
    np.testing.assert_array_equal(back, api.decode(data, device="cpu"))
    assert psnr(back, img) > 25.0   # bounded by 4:2:0 loss on noise


def test_stripes_above_one_exit_2(tmp_path, capsys):
    """--stripes above 1 once exited 2 (no stripe mode yet); it now writes
    the file parallel.mesh.encode_striped gives, and --stripes 1 the plain
    encode's."""
    img = synth_frame(16, 16, seed=3)[..., 0].copy()
    io.save(str(tmp_path / "in.pgm"), img)
    rc = cli_main(["encode", str(tmp_path / "in.pgm"),
                   str(tmp_path / "o.jpg"), "--stripes", "2", *CPU])
    assert rc == 0
    striped = mesh.encode_striped(img, 2, device="cpu")
    assert (tmp_path / "o.jpg").read_bytes() == striped
    assert striped == api.encode(img, restart_interval=2, device="cpu")
    assert cli_main(["encode", str(tmp_path / "in.pgm"),
                     str(tmp_path / "o.jpg"), "--stripes", "1", *CPU]) == 0
    assert (tmp_path / "o.jpg").read_bytes() == api.encode(img,
                                                           device="cpu")


def test_cuda_device_without_cuda_raises(tmp_path):
    assert not torch.cuda.is_available()
    io.save(str(tmp_path / "in.ppm"), synth_frame(16, 16, seed=4))
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["encode", str(tmp_path / "in.ppm"),
                  str(tmp_path / "o.jpg")])
    with pytest.raises(RuntimeError, match="cuda"):
        run_batch(_images(2, 16, 16), [str(tmp_path / "a.jpg")] * 2,
                  str(tmp_path / "m.jsonl"))
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.stage_batch(_images(2, 16, 16))
    assert not (tmp_path / "a.jpg").exists()


@pytest.mark.parametrize("args,gray,optimize", [
    (["--quality", "75", "--restart", "2"], False, False),
    (["--quality", "90", "--subsampling", "444"], False, False),
    (["--optimize"], True, True),
    (["--quality", "80", "--stripes", "3"], False, False)])
def test_cli_encode_files_match_reference_cli(tmp_path, args, gray,
                                              optimize):
    img = synth_frame(48, 80, seed=21)
    if gray:
        img = img[..., 1].copy()
    src = str(tmp_path / ("in.pgm" if gray else "in.png"))
    io.save(src, img)
    ours, ref = str(tmp_path / "ours.jpg"), str(tmp_path / "ref.jpg")
    assert cli_main(["encode", src, ours, *args, *CPU]) == 0
    assert jcli.main(["encode", src, ref, *args]) == 0
    quality = int(args[args.index("--quality") + 1]) \
        if "--quality" in args else 75
    _assert_split(open(ours, "rb").read(), open(ref, "rb").read(), quality,
                  optimize)


def test_cli_batch_files_match_reference_cli(tmp_path, capsys):
    indir = tmp_path / "in"
    indir.mkdir()
    for i in range(3):
        io.save(str(indir / f"f{i}.png"), synth_frame(24, 40, seed=30 + i))
    io.save(str(indir / "g.png"), synth_frame(16, 24, seed=40))
    assert cli_main(["batch", str(indir), str(tmp_path / "ours"),
                     "--quality", "80", "--chunk", "2", *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["images"], rec["done"], rec["skipped"]) == (4, 4, 0)
    assert jcli.main(["batch", str(indir), str(tmp_path / "ref"),
                      "--quality", "80", "--chunk", "2"]) == 0
    names = ["f0.jpg", "f1.jpg", "f2.jpg", "g.jpg"]
    assert sorted(os.listdir(tmp_path / "ours")) == names + ["manifest.jsonl"]
    for name in names:
        _assert_split((tmp_path / "ours" / name).read_bytes(),
                      (tmp_path / "ref" / name).read_bytes(), 80)
    assert [json.loads(ln)["index"] for ln in
            open(tmp_path / "ours" / "manifest.jsonl")] == \
        [json.loads(ln)["index"] for ln in
         open(tmp_path / "ref" / "manifest.jsonl")]
    assert cli_main(["batch", str(indir), str(tmp_path / "ours"),
                     "--quality", "80", *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["done"], rec["skipped"]) == (0, 4)


def test_cli_batch_empty_input_returns_1(tmp_path):
    (tmp_path / "in").mkdir()
    assert cli_main(["batch", str(tmp_path / "in"), str(tmp_path / "out"),
                     *CPU]) == 1


def test_cli_decode_equals_api_decode(tmp_path):
    img = synth_frame(33, 47, seed=8)
    data = api.encode(img, 70, "422", device="cpu")
    (tmp_path / "a.jpg").write_bytes(data)
    assert cli_main(["decode", str(tmp_path / "a.jpg"),
                     str(tmp_path / "a.png"), *CPU]) == 0
    np.testing.assert_array_equal(io.load(str(tmp_path / "a.png")),
                                  api.decode(data, device="cpu"))


def test_cli_bench_and_rd_curve(tmp_path, capsys):
    assert cli_main(["bench", "--size", "32x48", "--frames", "2",
                     "--profile", str(tmp_path / "prof"), *CPU]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["size"] == "32x48" and row["mpix_per_s"] > 0 and row["bpp"] > 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    img = synth_frame(32, 32, seed=2)
    io.save(str(tmp_path / "r.ppm"), img)
    assert cli_main(["rd-curve", "--input", str(tmp_path / "r.ppm"),
                     "--qualities", "30,90", *CPU]) == 0
    rows = [json.loads(ln)
            for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["quality"] for r in rows] == [30, 90]
    for r in rows:
        data = api.encode(img, r["quality"], device="cpu")
        assert r["bpp"] == round(8 * len(data) / img[..., 0].size, 4)
        assert r["psnr_db"] == round(
            psnr(api.decode(data, device="cpu"), img), 3)
    assert rows[1]["psnr_db"] > rows[0]["psnr_db"]


# --- the batch driver -----------------------------------------------------------

def test_batch_driver_completes_and_resumes(tmp_path):
    imgs = _images()
    outs = [str(tmp_path / f"img{i}.jpg") for i in range(len(imgs))]
    manifest = str(tmp_path / "manifest.jsonl")
    r1 = run_batch(imgs, outs, manifest, quality=75, chunk_size=3,
                   device="cpu")
    assert r1.done == len(imgs) and r1.skipped == 0 and r1.mpix_per_s > 0
    for i, p in enumerate(outs):
        assert open(p, "rb").read() == api.encode(imgs[i], 75, device="cpu")
    r2 = run_batch(imgs, outs, manifest, quality=75, chunk_size=3,
                   device="cpu")
    assert r2.done == 0 and r2.skipped == len(imgs)


def test_batch_resumes_after_a_torn_manifest_line(tmp_path):
    imgs = _images(5, 16, 24, seed=7)
    outs = [str(tmp_path / f"img{i}.jpg") for i in range(len(imgs))]
    manifest = tmp_path / "manifest.jsonl"
    run_batch(imgs, outs, str(manifest), chunk_size=2, device="cpu")
    lines = manifest.read_text().splitlines(keepends=True)
    torn = json.loads(lines[-1])["index"]
    # a crash in the middle of the last write: half a line, no newline
    manifest.write_text("".join(lines[:-1]) + lines[-1][:len(lines[-1]) // 2])
    os.remove(outs[torn])
    r = run_batch(imgs, outs, str(manifest), chunk_size=2, device="cpu")
    assert (r.done, r.skipped) == (1, len(imgs) - 1)
    assert open(outs[torn], "rb").read() == api.encode(imgs[torn], 75,
                                                       device="cpu")
    recs = []
    for ln in manifest.read_text().splitlines():
        try:
            recs.append(json.loads(ln)["index"])
        except ValueError:
            pass
    assert sorted(recs) == list(range(len(imgs)))
    # the torn line was ended, so the redone image's record is whole: the
    # next run redoes nothing
    r = run_batch(imgs, outs, str(manifest), chunk_size=2, device="cpu")
    assert (r.done, r.skipped) == (0, len(imgs))


def test_batch_driver_fault_injection(tmp_path):
    imgs = _images()
    outs = [str(tmp_path / f"img{i}.jpg") for i in range(len(imgs))]
    manifest = str(tmp_path / "manifest.jsonl")
    calls = {"n": 0}

    def flaky(chunk, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected host failure")
        return mesh.encode_batch(chunk, **kw)

    with pytest.raises(RuntimeError, match="injected"):
        run_batch(imgs, outs, manifest, chunk_size=3, encode_chunk=flaky,
                  device="cpu")
    done_before = len(open(manifest).readlines())
    assert 0 < done_before < len(imgs)
    # relaunch finishes only the remainder, and never rewrites finished files
    mtimes = {p: os.path.getmtime(p) for p in outs if os.path.exists(p)}
    r = run_batch(imgs, outs, manifest, chunk_size=3, device="cpu")
    assert r.skipped == done_before
    assert r.done == len(imgs) - done_before
    for p, t in mtimes.items():
        assert os.path.getmtime(p) == t
    recs = [json.loads(ln) for ln in open(manifest)]
    assert sorted(r["index"] for r in recs) == list(range(len(imgs)))


def test_mixed_shapes_group_as_the_reference_driver_does(tmp_path):
    """Over file paths of three shapes, the port's driver hands the encoder
    the same chunks in the same order as jpgenc_tpu.batch.run_batch, loads
    lazily, and writes the same manifest."""
    rng = np.random.default_rng(5)
    shapes = [(24, 16, 3), (24, 16, 3), (16, 24, 3), (24, 16, 3), (16, 24),
              (16, 24, 3), (24, 16, 3), (16, 24), (24, 16, 3)]
    paths = []
    for i, s in enumerate(shapes):
        p = str(tmp_path / f"in_{i}.{'pgm' if len(s) == 2 else 'ppm'}")
        io.save(p, rng.integers(0, 255, s, dtype=np.uint8))
        paths.append(p)
    seen = {}

    def recorder(name):
        def enc(chunk, **kw):
            seen.setdefault(name, []).append(
                [int(np.flatnonzero([np.array_equal(io.load(p), c)
                                     for p in paths])[0]) for c in chunk])
            return [bytes([7]) * (c.size % 251 + 1) for c in chunk]
        return enc

    for name, driver in (("ours", run_batch), ("ref", jbatch.run_batch)):
        d = tmp_path / name
        d.mkdir()
        outs = [str(tmp_path / "out" / f"{i}.jpg") for i in range(len(paths))]
        os.makedirs(tmp_path / "out", exist_ok=True)
        kw = {"device": "cpu"} if name == "ours" else {}
        res = driver(paths, outs, str(d / "m.jsonl"), chunk_size=2,
                     encode_chunk=recorder(name), **kw)
        assert (res.done, res.skipped) == (len(paths), 0)
    assert seen["ours"] == seen["ref"]
    assert (tmp_path / "ours" / "m.jsonl").read_bytes() == \
        (tmp_path / "ref" / "m.jsonl").read_bytes()
    # chunks never mix shapes and never exceed chunk_size
    for chunk in seen["ours"]:
        assert len(chunk) <= 2 and len({shapes[i] for i in chunk}) == 1


def test_file_driven_batch_mixed_shapes(tmp_path):
    """run_batch over file paths with two shape groups, encoded on the CPU:
    each file decodes to its source's shape, and resume is idempotent."""
    rng = np.random.default_rng(17)
    shapes = [(24, 16, 3), (24, 16, 3), (16, 24, 3), (24, 16, 3), (16, 24)]
    paths, outs = [], []
    for i, s in enumerate(shapes):
        a = rng.integers(0, 255, s, dtype=np.uint8)
        p = str(tmp_path / f"in_{i}.png")
        io.save(p, a)
        paths.append(p)
        outs.append(str(tmp_path / f"out_{i}.jpg"))
    manifest = str(tmp_path / "manifest.jsonl")
    res = run_batch(paths, outs, manifest, quality=75, chunk_size=2,
                    device="cpu")
    assert res.done == 5 and res.skipped == 0
    for p, o in zip(paths, outs):
        data = open(o, "rb").read()
        assert data == api.encode(io.load(p), 75, device="cpu")
        assert api.decode(data, device="cpu").shape == io.load(p).shape
    res2 = run_batch(paths, outs, manifest, quality=75, chunk_size=2,
                     device="cpu")
    assert res2.done == 0 and res2.skipped == 5


@pytest.mark.parametrize("kw", [{}, {"optimize": True, "restart_interval": 2},
                                {"dct_method": "islow", "quality": 90}])
def test_run_batch_with_stage_batch_equals_without(tmp_path, kw):
    imgs = _images(5, 32, 40, seed=23)
    files = {}
    for name, chunk_fn in (("staged", None), ("plain", mesh.encode_batch)):
        outs = [str(tmp_path / f"{name}{i}.jpg") for i in range(len(imgs))]
        run_batch(imgs, outs, str(tmp_path / f"{name}.jsonl"), chunk_size=2,
                  device="cpu", encode_chunk=chunk_fn, **kw)
        files[name] = [open(p, "rb").read() for p in outs]
    assert files["staged"] == files["plain"]
    assert files["plain"][0] == api.encode(imgs[0], device="cpu", **{
        "optimize": False, **{k: v for k, v in kw.items()}})


@pytest.mark.parametrize("gray", [False, True])
def test_encode_batch_staged_equals_unstaged(gray):
    imgs = _images(3, 24, 32, seed=29)
    if gray:
        imgs = imgs[..., 0].copy()
    staged = mesh.stage_batch(imgs, quality=60, device="cpu")
    assert staged[0] is not None and len(staged[1]) == 1 \
        and staged[1][0][1] is None
    assert mesh.encode_batch(None, quality=60, device="cpu",
                             staged=staged) == \
        mesh.encode_batch(imgs, quality=60, device="cpu")
