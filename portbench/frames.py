"""The benchmark's input frames, made on the device from the seed.

A configuration names its content (`content` in its file):

- `"fixture"`: a torch copy of the port's `utils/fixtures.synth_frame`, a
  gradient plus a sinusoid, 25 levels apart per channel, plus Gaussian
  noise of sigma 12, clipped and truncated to uint8. The gradient runs past
  255 over most of a frame, so most of it clips to flat white: about 0.24
  bits per pixel at 1080p Q75 4:2:0, 0.08 at 4K.
- `"photographic"`: a scene of smooth random regions (four octaves of
  interpolated noise, 64 to 512 pixels), a colour wash per channel (32 and
  128 pixels), and detail texture (six octaves, 1 to 32 pixels, equal
  weights) whose amplitude varies across the frame by a mask of 256-pixel
  noise, so that busy and flat regions alternate. Each frame's detail
  amplitude is one of the configuration's `amplitude` levels; the levels
  are calibrated to the bits per pixel the configuration records
  (`content.bpp`, `assumed.content`).

Every random number comes from one `torch.Generator` seeded with the run's
seed on the device the frames are made on, so every frame is distinct and
the same seed gives the same frames. Made a few frames to a call, so the
float32 temporaries stay small.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NOISE = 12.0
CHUNK = 8          # frames made per call of the generator
SCENE = (64, 128, 256, 512)     # octaves (pixels) of the scene
WASH = (32, 128)                # of each channel's colour wash
DETAIL = (1, 2, 4, 8, 16, 32)   # of the detail texture
MASK = (256,)                   # of the detail's amplitude mask


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def levels(config: dict, distinct: int, per_call: int, seed: int):
    """Each frame's detail amplitude, [distinct][per_call], or None for the
    fixture. Frame k of the cell's distinct * per_call takes level k modulo
    the number of levels, so every call holds each level equally where its
    frames are a multiple of the levels, and every seed the same set in
    all; the seed shuffles the calls and the frames within each call."""
    content = config.get("content", {"kind": "fixture"})
    if content["kind"] == "fixture":
        return None
    if content["kind"] != "photographic":
        raise ValueError(f"content {content['kind']!r} is not fixture or "
                         "photographic")
    amps = [float(a) for a in content["amplitude"]]
    rng = np.random.default_rng(seed)
    grid = np.arange(distinct * per_call).reshape(distinct, per_call) % \
        len(amps)
    grid = rng.permuted(grid[rng.permutation(distinct)], axis=1)
    return [[amps[k] for k in row] for row in grid]


def _base(h: int, w: int, device) -> torch.Tensor:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return 96.0 * torch.sin(xx / 17.0) * torch.cos(yy / 23.0) + \
        0.35 * xx + 0.2 * yy + 96.0


def _octaves(k: int, h: int, w: int, sizes, gen, device) -> torch.Tensor:
    """[k, h, w]: the sum, over `sizes`, of unit Gaussian noise on a grid
    of that many pixels, interpolated bilinearly."""
    acc = torch.zeros((k, 1, h, w), device=device)
    for s in sizes:
        g = torch.randn((k, 1, h // s + 2, w // s + 2), generator=gen,
                        device=device)
        if s > 1:
            g = F.interpolate(g, scale_factor=s, mode="bilinear",
                              align_corners=False)
        acc += g[..., :h, :w]
    return acc[:, 0]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.std(dim=(-2, -1), keepdim=True)


def _photographic(amps, h: int, w: int, channels: int, gen,
                  device) -> torch.Tensor:
    """float32 [k, h, w, channels] ([k, h, w] gray) before clipping."""
    k = len(amps)
    scene = _unit(_octaves(k, h, w, SCENE, gen, device))
    detail = _unit(_octaves(k, h, w, DETAIL, gen, device))
    mask = torch.sigmoid(2.5 * _octaves(k, h, w, MASK, gen, device)) * \
        1.8 + 0.05
    amp = torch.tensor(amps, dtype=torch.float32, device=device)
    common = 118.0 + 45.0 * scene + amp[:, None, None] * mask * detail
    if not channels:
        return common
    return torch.stack(
        [common + 18.0 * _unit(_octaves(k, h, w, WASH, gen, device))
         for _ in range(channels)], dim=-1)


def frames(n: int, h: int, w: int, channels: int, gen: torch.Generator,
           device, amps=None) -> torch.Tensor:
    """[n, h, w, channels] uint8 ([n, h, w] for channels 0) on `device`:
    the fixture, or photographic content at each frame's amplitude."""
    shape = (n, h, w, channels) if channels else (n, h, w)
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    if amps is not None:
        for i in range(0, n, CHUNK):
            x = _photographic(amps[i:i + CHUNK], h, w, channels, gen, device)
            out[i:i + x.shape[0]] = x.clamp_(0, 255).to(torch.uint8)
        return out
    base = _base(h, w, device)
    offs = (torch.arange(channels, dtype=torch.float32, device=device) * 25.0
            if channels else torch.zeros((), device=device))
    for i in range(0, n, CHUNK):
        k = min(CHUNK, n - i)
        noise = torch.randn((k,) + shape[1:], generator=gen, device=device)
        x = (base[..., None] + offs if channels else base) + NOISE * noise
        out[i:i + k] = x.clamp_(0, 255).to(torch.uint8)
    return out


def to_host(x: torch.Tensor) -> np.ndarray:
    """A pageable numpy copy of a device batch, through one pinned buffer
    of CHUNK frames (a pageable device-to-host copy is several times
    slower)."""
    out = np.empty(tuple(x.shape), np.uint8)
    if x.device.type != "cuda":
        out[...] = x.numpy()
        return out
    pin = torch.empty((min(CHUNK, x.shape[0]),) + tuple(x.shape[1:]),
                      dtype=torch.uint8, pin_memory=True)
    for i in range(0, x.shape[0], CHUNK):
        k = min(CHUNK, x.shape[0] - i)
        pin[:k].copy_(x[i:i + k])
        out[i:i + k] = pin[:k].numpy()
    return out
