"""The benchmark cell `gray512_q75.batch512_device`'s path on the CPU at a
small size, and what its traced runs read:

- `mesh.encode_batch` of gray photographic frames (`portbench/frames.py`
  with `channels` 0, one frame of each of the configuration's eight detail
  levels): every file exactly the benchmark reference's coding of its own
  coefficients (`portbench/reference`, one component, Annex K luminance
  tables), and the coefficients against the reference's float32
  `image_to_zigzag`. For integer gray pixels the coefficients at zigzag 0,
  10, 14 and 39 (natural (0,0), (4,0), (0,4), (4,4)), whose basis product
  is +-1/8, are often exact halves; the port's KDCT_ZZ holds 0.12499999
  there and rounds most such ties toward zero, the reference's separable
  product most of them away. So each differing coefficient is held to be
  one of those exact ties, 1 apart, and the rest to the knife-edge policy
  (|diff| <= 1 on at most max(1e-4, 2/size)): none differ;
- a retried row opens, inside its `jpgenc.retry` range, exactly one range
  of why it overflowed the tight tier: `jpgenc.retry.block` for a block past
  w_blk, else `jpgenc.retry.stream` for words past the stream's capacity;
  the ranges change no byte;
- the cell's new per-layer readers, `k1a_gray_roofline` and
  `overflow_block_pct`, on a synthetic trace.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jpgenc_tpu_torch import engine
from jpgenc_tpu_torch.config import EncodeConfig
from jpgenc_tpu_torch.parallel import mesh
from portbench import frames, harness, judge, roofline
from portbench.reference import decoder as ref_dec
from portbench.reference import encoder as ref_enc
from portbench.reference import tables as ref_tables
from portbench.tracing import CALL, Context, Trace

ROOT = Path(__file__).resolve().parent.parent
CELL = "gray512_q75.batch512_device"
CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "gray512_q75.json").read_text())
LIMITS = json.loads((ROOT / "portbench" / "limits" /
                     f"{CELL}.json").read_text())
Q = CONFIG["quality"]
KW = dict(quality=Q, subsampling=CONFIG["subsampling"],
          restart_interval=CONFIG["restart_interval"],
          optimize=CONFIG["optimize"], dct_method=CONFIG["dct_method"])
H, W = 128, 256
TIE_POSITIONS = {0, 10, 14, 39}


def _photographic(seed: int) -> torch.Tensor:
    amps = CONFIG["content"]["amplitude"]
    return frames.frames(len(amps), H, W, CONFIG["channels"],
                         frames.generator(seed, "cpu"), "cpu", amps)


def _exact_zigzag(frame: np.ndarray) -> np.ndarray:
    """The frame's unrounded quantized coefficients in float64,
    [n_blocks, 64] in zigzag order."""
    c = ref_enc.dct_matrix(np.float64)
    coef = np.einsum("ij,njk,lk->nil", c,
                     ref_enc.blockify(frame.astype(np.float64) - 128.0), c)
    q = ref_enc.qtables_for(Q)[0].reshape(8, 8).astype(np.float64)
    return (coef / q).reshape(-1, 64)[:, ref_tables.ZIGZAG]


def _reference_coding(frame: np.ndarray, data: bytes):
    """(the file's coefficients, the reference's) after asserting the file
    is the reference's coding of its own coefficients, as gray."""
    layout = ref_enc.layout_for(frame.shape, CONFIG["subsampling"],
                                CONFIG["restart_interval"])
    assert layout.subsampling == "gray"
    got = ref_dec.decode_coefficients(ref_dec.parse(data), layout)
    assert ref_enc.encode_blocks(layout, got, Q, CONFIG["optimize"]) == data
    return got, ref_enc.image_to_zigzag(frame, layout,
                                        ref_enc.qtables_for(Q))


@pytest.mark.parametrize("seed", (2**31 + 22, 7))
def test_gray_batch_holds_the_benchmark_reference(seed):
    x = _photographic(seed)
    files = mesh.encode_batch(x, device="cpu", **KW)
    assert len(files) == len(x)
    for frame, data in zip(x.numpy(), files):
        got, want = _reference_coding(frame, data)
        d = np.abs(got.astype(np.int64) - want)
        assert d.max() <= 1
        blocks, pos = np.nonzero(d)
        assert set(pos.tolist()) <= TIE_POSITIONS
        exact = _exact_zigzag(frame)[blocks, pos]
        assert np.all(np.abs(np.abs(exact) % 1.0 - 0.5) < 1e-9)
        untied = np.ones(d.shape, bool)
        untied[blocks, pos] = False
        assert (d[untied] > 0).mean() <= max(1e-4, 2.0 / d.size)
    checks = judge.held(judge.judge_encode(list(zip(x.numpy(), files)),
                                           CONFIG), LIMITS)
    assert set(checks) == set(LIMITS) and judge.passes(checks), checks


def _cause_frames(cause: str) -> torch.Tensor:
    """[3, H, W]: a smooth frame, a frame that overflows the tight tier for
    `cause`, a smooth frame. "block": flat but for one 8 x 8 block of 0/255
    noise, a block far past w_blk with a stream far under its capacity;
    "stream": Gaussian noise of sigma 26, each block under 256 bits (w_blk
    8 at Q75) and the stream past its capacity."""
    rng = np.random.default_rng(2**31 + 40)
    smooth = _photographic(2**31 + 41)[:2].numpy()
    if cause == "block":
        odd = np.full((H, W), 120, np.uint8)
        odd[64:72, 128:136] = rng.integers(0, 2, (8, 8)) * 255
    else:
        odd = np.clip(128 + rng.normal(0, 26, (H, W)), 0,
                      255).astype(np.uint8)
    return torch.from_numpy(np.stack([smooth[0], odd, smooth[1]]))


def _tight_causes(x: torch.Tensor) -> list:
    plan = engine.get_plan(H, W, "gray", Q, "cpu")
    job = engine.EncodeJob(plan, EncodeConfig(quality=Q), x)
    job.first_pass()
    job.second_pass()
    scans = job.finish()
    assert [s is None for s in scans] == [c is not None for c in job.causes]
    return job.causes


def _ranges(prof) -> list:
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("jpgenc.retry")),
                  key=lambda r: r[1])


@pytest.mark.parametrize("cause", ["block", "stream"])
def test_a_retried_row_names_its_cause(cause):
    x = _cause_frames(cause)
    assert _tight_causes(x) == [None, cause, None]
    plan = engine.get_plan(H, W, "gray", Q, "cpu")
    _, _, ovf = plan(x[1:2], *engine.tiers_for(plan.layout, Q)[0])
    assert bool(ovf[0]) == (cause == "block")
    want = mesh.encode_batch(x, device="cpu", **KW)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = mesh.encode_batch(x, device="cpu", **KW)
    assert got == want
    ranges = _ranges(prof)
    retries = [r for r in ranges if r[0] == "jpgenc.retry"]
    causes = [r for r in ranges if r[0] != "jpgenc.retry"]
    assert len(retries) == 1
    assert [r[0] for r in causes] == [f"jpgenc.retry.{cause}"]
    (_, s, e), (_, a, b) = retries[0], causes[0]
    assert s <= a and b <= e
    for frame, data in zip(x.numpy(), got):
        got_coef, want_coef = _reference_coding(frame, data)
        assert np.abs(got_coef.astype(np.int64) - want_coef).max() <= 1


def test_each_retried_row_opens_one_cause():
    """Both causes in one batch, on two device entries: one cause range a
    retried row, in row order, each inside its own retry range."""
    x = torch.cat([_cause_frames("block"), _cause_frames("stream")])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mesh.encode_batch(x, devices=["cpu", "cpu"], **KW)
    ranges = _ranges(prof)
    retries = [r for r in ranges if r[0] == "jpgenc.retry"]
    causes = [r for r in ranges if r[0] != "jpgenc.retry"]
    assert [r[0] for r in causes] == ["jpgenc.retry.block",
                                      "jpgenc.retry.stream"]
    for (_, s, e), (_, a, b) in zip(retries, causes):
        assert s <= a and b <= e


# --- the cell's new readers on a synthetic trace ---------------------------

class _Event:
    def __init__(self, name, start, end, device="cpu", annotation=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return f"DeviceType.{self._d.upper()}"

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return 1

    def device_index(self):
        return 0


def _context(events, images=4, scan_bytes=0) -> Context:
    class Results:
        def events(self):
            return [_Event(CALL, 0, 10**6, annotation=True)] + events

    class Profiler:
        kineto_results = Results()

    class Prof:
        profiler = Profiler()
    return Context(Trace(Prof()), [0], CONFIG, {}, 1, images, scan_bytes, {})


def _read(metric: str, ctx):
    return harness.Registry(ROOT).reader(metric)(ctx)


def test_k1a_gray_roofline_reads_the_gray_kernel_alone():
    """The bound of the window's gray frames over the device time of
    `k1a_gray_kernel` launches; the colour K1A's time is not counted, and
    a trace without the gray kernel reads None."""
    scan = 4 * 30000
    ctx = _context([_Event("void k1a_gray_kernel(unsigned char const*)",
                           100, 400100, device="cuda"),
                    _Event("k1a_gray_kernel", 500000, 600000,
                           device="cuda"),
                    _Event("k1a_kernel<2, 2>", 700000, 900000,
                           device="cuda")], scan_bytes=scan)
    bound = roofline.k1a(CONFIG, 4, scan, 2)
    lay = roofline.layout(CONFIG)
    assert lay.blocks_per_mcu == 1 and lay.n_scan == 4096
    assert bound == pytest.approx(
        (4 * 512 * 512 + scan + 2 * (4 * (64 * 64 + 64) +
                                     roofline.TABLE_BYTES)) /
        roofline.HBM_BYTES_PER_S)
    assert _read("k1a_gray_roofline.gray512", ctx) == \
        pytest.approx(100.0 * bound / 500e-6)
    assert _read("k1a_gray_roofline.gray512", _context(
        [_Event("k1a_kernel", 100, 200, device="cuda")])) is None


@pytest.mark.parametrize("spans,want", [
    ([], None),                                       # no span of the program
    ([("jpgenc.fetch_wait", 10, 20)], 0.0),           # nothing retried
    ([("jpgenc.retry", 10, 90), ("jpgenc.retry", 100, 190)], None),  # no cause
    ([("jpgenc.retry", 10, 90), ("jpgenc.retry.block", 20, 80),
      ("jpgenc.retry", 100, 190), ("jpgenc.retry.stream", 110, 180)], 25.0),
    ([("jpgenc.retry", 10, 90), ("jpgenc.retry.block", 20, 80),
      ("jpgenc.retry", 100, 190), ("jpgenc.retry.block", 110, 180)], 50.0),
])
def test_overflow_block_pct_counts_block_causes(spans, want):
    """Block-cause ranges over the window's images; at most overflow_pct,
    and silent for a program whose retries name no cause."""
    ctx = _context([_Event(*s) for s in spans])
    got = _read("overflow_block_pct.gray512", ctx)
    assert got == want
    if got is not None:
        assert got <= _read("overflow_pct.gray512", ctx)
