"""The benchmark's plain reference agrees with the port's plain CPU path and
with the port's frozen loop coder, and its reader refuses broken files."""
import numpy as np
import pytest

from portbench.reference import decoder as ref_dec
from portbench.reference import encoder as ref_enc

# (height, width, restart interval, optimize): odd sizes, padding, RSTn
CASES = [(48, 80, 0, False), (61, 130, 0, True), (40, 72, 3, False),
         (33, 47, 1, True)]


def _frame(h, w, seed):
    """Gradient + sinusoid + noise, as the benchmark's frames."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96.0 * np.sin(xx / 17.0) * np.cos(yy / 23.0) + 0.35 * xx + \
        0.2 * yy + 96.0
    rng = np.random.default_rng(seed)
    img = np.stack([base + 25.0 * c + rng.normal(0, 12, (h, w))
                    for c in range(3)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sub", ["420", "422", "444"])
@pytest.mark.parametrize("h,w,ri,opt", CASES)
def test_same_bytes_as_the_port_plain_path(h, w, ri, opt, sub):
    from jpgenc_tpu_torch import api
    img = _frame(h, w, h * w)
    ours = ref_enc.encode(img, 75, sub, ri, opt)
    assert ours == api.encode(img, 75, sub, ri, opt, device="cpu")


@pytest.mark.parametrize("h,w,ri,opt", CASES)
def test_same_bytes_as_the_port_loop_coder(h, w, ri, opt):
    """The whole-array coder against the port's frozen loop reference."""
    from jpgenc_tpu_torch.ref import encoder as port_ref
    img = _frame(h, w, 7)
    assert ref_enc.encode(img, 75, "420", ri, opt) == \
        port_ref.encode(img, 75, "420", ri, opt)


@pytest.mark.parametrize("h,w,ri,opt", CASES)
def test_decoder_reads_back_coefficients_and_pixels(h, w, ri, opt):
    from jpgenc_tpu_torch import api
    img = _frame(h, w, 3)
    data = ref_enc.encode(img, 75, "420", ri, opt)
    parsed = ref_dec.parse(data)
    layout = ref_dec.layout_of(parsed)
    got = ref_dec.decode_coefficients(parsed, layout)
    want = ref_enc.image_to_zigzag(img, layout, ref_enc.qtables_for(75))
    assert np.array_equal(got, want)
    assert ref_enc.encode_blocks(layout, got, 75, opt) == data
    # float32 both: the port's plain decode gives the same pixels
    assert np.array_equal(ref_dec.decode(data),
                          np.asarray(api.decode(data, device="cpu")))


def test_tf32_moves_coefficients():
    """The control's precision differs from float32 on a real frame."""
    img = _frame(128, 192, 11)
    lay = ref_enc.layout_for(img.shape, "420", 0)
    qts = ref_enc.qtables_for(75)
    a = ref_enc.image_to_zigzag(img, lay, qts)
    b = ref_enc.image_to_zigzag(img, lay, qts, "tf32")
    assert 0 < np.count_nonzero(a != b) and np.abs(a - b).max() <= 2


@pytest.mark.parametrize("damage", ["truncate", "flip", "no_eoi", "marker"])
def test_broken_files_are_refused(damage):
    data = bytearray(ref_enc.encode(_frame(48, 80, 5), 75, "420"))
    sos = data.index(b"\xff\xda")
    mid = (sos + len(data)) // 2
    if damage == "truncate":
        data = data[:mid] + b"\xff\xd9"
    elif damage == "flip":
        data[mid] ^= 0x5A
    elif damage == "no_eoi":
        data = data[:-2]
    else:
        data[mid:mid + 2] = b"\xff\xc4"
    layout = ref_enc.layout_for((48, 80, 3), "420", 0)
    try:
        parsed = ref_dec.parse(bytes(data))
        got = ref_dec.decode_coefficients(parsed, layout)
    except (ref_dec.DecodeError, IndexError):
        return
    # a flip can decode: then it decodes to other coefficients or codes
    # to other bytes
    assert ref_enc.encode_blocks(layout, got, 75, False) != bytes(data) or \
        not np.array_equal(got, ref_enc.image_to_zigzag(
            _frame(48, 80, 5), layout, ref_enc.qtables_for(75)))
