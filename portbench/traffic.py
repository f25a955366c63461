"""The one generator every traffic mix runs: a mix is a data file of
parameters (`traffic/<mix>.json`), read here.

Parameters of a mix:

- `entry`: the port's entry the window drives:
  - `encode_batch`: `parallel.mesh.encode_batch` of `frames_per_call`
    frames, from `source` "device" (one uint8 tensor on the first card, the
    device-resident producer interface) or "host" (pageable numpy);
    with `staged` true, through `parallel.mesh.stage_batch`, the next
    call's batch staged before this call's encode (one chunk prefetched,
    as `batch.run_batch` does);
  - `encode`: `api.encode` of one frame a call;
  - `decode_batch`: `api.decode_batch(files, to_device=True, chunk=)`
    of `frames_per_call` files that set-up encodes with the port, ending
    in pixels on the card, synchronised. The frames they were made from
    are kept on the host, so that the reference checks the files too.
- `distinct`: how many distinct batches (or frames, for `encode`) the
  seed makes; call i takes number i modulo `distinct`. Each frame's
  content level is drawn as `frames.levels` says.
- `devices`: the cards one call spreads over (a device list of
  `cuda:0` ... ; 1 passes `device` alone).
- `sample_images`: how many of the window's images the reference checks.

The loop is closed: one caller, and the next call starts when the last
returns. A call returns what the entry produced, with every byte or pixel
in place on the host or the card: the host clock around it covers the
device's work.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import frames

ENTRIES = ("encode_batch", "encode", "decode_batch")


@dataclass
class Call:
    start: float
    end: float
    outputs: object         # list of bytes, or the decoder's list of tensors
    error: str = ""


class Driver:
    """Inputs made from the seed and the call the window drives."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 port):
        if traffic["entry"] not in ENTRIES:
            raise ValueError(f"entry {traffic['entry']!r} is not one of "
                             f"{ENTRIES}")
        self.cfg, self.mix, self.port = config, traffic, port
        self.seed = int(seed)
        n_dev = int(traffic.get("devices", 1))
        self.devices = ([f"{device}:{i}" for i in range(n_dev)]
                        if device == "cuda" else [device] * n_dev)
        self.device = self.devices[0]
        self.per_call = int(traffic["frames_per_call"])
        self.distinct = int(traffic.get("distinct", 1))
        self.kw = dict(quality=config["quality"],
                       subsampling=config["subsampling"],
                       restart_interval=config["restart_interval"])
        self.enc_kw = dict(self.kw, optimize=config["optimize"],
                           dct_method=config["dct_method"])
        self.inputs: list = []      # per distinct: tensor, numpy or files
        self.frames_host: list = []  # per distinct: numpy frames (reference)
        self._staged, self._staged_for = None, None

    # --- set-up -------------------------------------------------------------
    @property
    def pixels_per_image(self) -> int:
        return self.cfg["height"] * self.cfg["width"]

    def make_inputs(self) -> None:
        cfg, mix = self.cfg, self.mix
        gen = frames.generator(self.seed, self.device)
        n = 1 if mix["entry"] == "encode" else self.per_call
        amps = frames.levels(cfg, self.distinct, n, self.seed)
        for b in range(self.distinct):
            x = frames.frames(n, cfg["height"], cfg["width"],
                              cfg["channels"], gen, self.device,
                              None if amps is None else amps[b])
            if mix["entry"] == "decode_batch":
                self.frames_host.append(frames.to_host(x))
                self.inputs.append(self.port.mesh.encode_batch(
                    x, device=self.device, **self.enc_kw))
            elif mix.get("source", "device") == "host":
                host = frames.to_host(x)
                self.frames_host.append(host)
                self.inputs.append(host[0] if mix["entry"] == "encode"
                                   else host)
            else:
                self.frames_host.append(None)
                self.inputs.append(x[0] if mix["entry"] == "encode" else x)
            del x

    def frame(self, i: int, j: int) -> np.ndarray:
        """The pixels of image j of call i, as the reference reads them."""
        k = i % self.distinct
        if self.frames_host[k] is not None:
            host = self.frames_host[k]
            return host[0] if self.mix["entry"] == "encode" else host[j]
        x = self.inputs[k]
        return (x if self.mix["entry"] == "encode" else x[j]).cpu().numpy()

    def file(self, i: int, j: int) -> bytes:
        return self.inputs[i % self.distinct][j]

    # --- the call -----------------------------------------------------------
    def _stage(self, i: int):
        return self.port.mesh.stage_batch(
            self.inputs[i % self.distinct], devices=self.devices, **self.kw)

    def _device_arg(self) -> dict:
        return ({"devices": self.devices} if len(self.devices) > 1
                else {"device": self.device})

    def call(self, i: int):
        mix, port = self.mix, self.port
        if mix["entry"] == "encode":
            return [port.api.encode(self.inputs[i % self.distinct],
                                    device=self.device, **self.enc_kw)]
        if mix["entry"] == "decode_batch":
            out = port.api.decode_batch(self.inputs[i % self.distinct],
                                        to_device=True,
                                        chunk=int(mix.get("chunk",
                                                          self.per_call)),
                                        device=self.device)
            if self.device.startswith("cuda"):
                torch.cuda.synchronize(self.device)
            return out
        if mix.get("staged"):
            cur = self._staged if self._staged_for == i else self._stage(i)
            self._staged, self._staged_for = self._stage(i + 1), i + 1
            return port.mesh.encode_batch(None, staged=cur,
                                          **self._device_arg(), **self.enc_kw)
        return port.mesh.encode_batch(self.inputs[i % self.distinct],
                                      **self._device_arg(), **self.enc_kw)

    def sync(self) -> None:
        for d in self.devices:
            if d.startswith("cuda"):
                torch.cuda.synchronize(d)

    def finish(self) -> None:
        """Let an upload staged ahead of the window's end land."""
        self._staged = self._staged_for = None
        self.sync()

    # --- what came back -----------------------------------------------------
    def well_formed(self, outputs) -> int:
        """How many of a call's images came back in the shape they must."""
        if self.mix["entry"] == "decode_batch":
            shape = (self.cfg["height"], self.cfg["width"]) + \
                ((self.cfg["channels"],) if self.cfg["channels"] else ())
            if not isinstance(outputs, list) or not all(
                    isinstance(t, torch.Tensor) and t.dtype == torch.uint8
                    and tuple(t.shape[1:]) == shape for t in outputs):
                return 0
            return min(sum(int(t.shape[0]) for t in outputs), self.per_call)
        if not isinstance(outputs, list):
            return 0
        return sum(1 for f in outputs[:self.images_per_call] if _is_jfif(f))

    def output(self, outputs, j: int):
        """Image j of one call's outputs (None where it is missing): a file,
        or a copy of the decoded pixels where they lie."""
        if not isinstance(outputs, list):
            return None
        if self.mix["entry"] != "decode_batch":
            return outputs[j] if j < len(outputs) else None
        for t in outputs:
            if isinstance(t, torch.Tensor) and j < t.shape[0]:
                return t[j].clone()
            j -= int(t.shape[0]) if isinstance(t, torch.Tensor) else 0
        return None

    @property
    def images_per_call(self) -> int:
        return 1 if self.mix["entry"] == "encode" else self.per_call


def _is_jfif(f) -> bool:
    return isinstance(f, bytes) and f[:2] == b"\xff\xd8" and \
        f[-2:] == b"\xff\xd9"


def run_window(driver: Driver, seconds: float, keep) -> tuple:
    """Drive calls for `seconds`: start none after the window's length has
    passed, and end the window when the last one returns. `keep(i, call)`
    sees every call as it ends. Returns (window start, window end, n)."""
    t0 = time.perf_counter()
    i = 0
    while (start := time.perf_counter()) - t0 < seconds:
        try:
            out, err = driver.call(i), ""
        except Exception as exc:    # noqa: BLE001  (a failed call is counted)
            out, err = None, f"{type(exc).__name__}: {exc}"
        keep(i, Call(start, time.perf_counter(), out, err))
        i += 1
    return t0, time.perf_counter(), i
