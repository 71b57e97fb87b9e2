"""The card's energy over the window, for ``images_per_j``.

The first choice is the driver's own counter, NVML's
``nvmlDeviceGetTotalEnergyConsumption`` (millijoules since the driver
loaded), read through ``ctypes`` from ``libnvidia-ml.so.1``, which ships
with the driver.  Where the library or the call is missing, a child
``nvidia-smi`` samples ``power.draw`` every 100 ms and the samples that
fall in the window are integrated.  Both also say the card's name and
power limit."""
from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from typing import List, Optional, Sequence, Tuple

SMI_PERIOD_MS = 100


class NvmlError(RuntimeError):
    """An NVML call returned another code than success."""


class NvmlMeter:
    """The energy counter of one card through NVML.  ``lib`` stands in for
    ``libnvidia-ml.so.1`` in tests."""

    source = "nvml"

    def __init__(self, uuid: Optional[str] = None, index: int = 0, lib=None):
        self.lib = lib if lib is not None else ctypes.CDLL(
            "libnvidia-ml.so.1")
        c = ctypes
        self._declare("nvmlInit_v2", [])
        self._declare("nvmlShutdown", [])
        self._declare("nvmlDeviceGetHandleByUUID",
                      [c.c_char_p, c.POINTER(c.c_void_p)])
        self._declare("nvmlDeviceGetHandleByIndex_v2",
                      [c.c_uint, c.POINTER(c.c_void_p)])
        self._declare("nvmlDeviceGetTotalEnergyConsumption",
                      [c.c_void_p, c.POINTER(c.c_ulonglong)])
        self._declare("nvmlDeviceGetName",
                      [c.c_void_p, c.c_char_p, c.c_uint])
        self._declare("nvmlDeviceGetPowerManagementLimit",
                      [c.c_void_p, c.POINTER(c.c_uint)])
        self._call("nvmlInit_v2")
        self._open = True
        self.handle = c.c_void_p()
        try:
            try:
                if not uuid:
                    raise NvmlError("no UUID")
                self._call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                           c.byref(self.handle))
            except NvmlError:
                self._call("nvmlDeviceGetHandleByIndex_v2", index,
                           c.byref(self.handle))
            self.energy_mj()    # a card without the counter fails here
        except NvmlError:
            self.close()
            raise
        self._e0: Optional[int] = None

    def _declare(self, name: str, argtypes) -> None:
        fn = getattr(self.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

    def _call(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise NvmlError(f"{name} returned {rc}")

    def energy_mj(self) -> int:
        v = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(v))
        return int(v.value)

    def describe(self) -> Tuple[str, float]:
        """``(card name, power limit in W)``."""
        buf = ctypes.create_string_buffer(96)
        self._call("nvmlDeviceGetName", self.handle, buf, 96)
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerManagementLimit", self.handle,
                   ctypes.byref(mw))
        return buf.value.decode(), mw.value / 1000.0

    def start(self) -> None:
        self._e0 = self.energy_mj()

    def stop(self) -> float:
        """Joules since `start`."""
        return (self.energy_mj() - self._e0) / 1000.0

    def close(self) -> None:
        if self._open:
            self._open = False
            self.lib.nvmlShutdown()


def integrate(samples: Sequence[Tuple[float, float]], t0: float,
              t1: float) -> float:
    """Joules of ``(time, watts)`` samples over ``[t0, t1]``: the power
    held piecewise linear between samples and flat beyond the first and
    the last."""
    pts = sorted(samples)
    if not pts:
        raise ValueError("no power samples")
    if t1 <= t0:
        return 0.0

    def watts(t: float) -> float:
        if t <= pts[0][0]:
            return pts[0][1]
        if t >= pts[-1][0]:
            return pts[-1][1]
        for (ta, wa), (tb, wb) in zip(pts, pts[1:]):
            if ta <= t <= tb:
                return wa if tb == ta else wa + (wb - wa) * (t - ta) / (tb - ta)
        raise AssertionError("unreachable")

    knots = [t0] + [t for t, _ in pts if t0 < t < t1] + [t1]
    return sum((tb - ta) * (watts(ta) + watts(tb)) / 2.0
               for ta, tb in zip(knots, knots[1:]))


class SmiMeter:
    """``power.draw`` sampled by a child ``nvidia-smi``, stamped on this
    process's clock as each line arrives.  ``cmd`` stands in for the
    sampler in tests: it prints one number of watts a line."""

    source = "nvidia-smi"

    def __init__(self, index: int = 0, cmd: Optional[List[str]] = None):
        self.index = index
        self.cmd = cmd or ["nvidia-smi", "-i", str(index),
                           "--query-gpu=power.draw",
                           "--format=csv,noheader,nounits",
                           f"--loop-ms={SMI_PERIOD_MS}"]
        self.samples: List[Tuple[float, float]] = []
        self._lock = threading.Lock()
        self._proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self._t0: Optional[float] = None

    def _read(self) -> None:
        for line in self._proc.stdout:
            t = time.perf_counter()
            try:
                w = float(line.strip().split(",")[0])
            except ValueError:
                continue
            with self._lock:
                self.samples.append((t, w))

    def describe(self) -> Tuple[str, float]:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(self.index),
             "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout
        name, limit = out.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        t1 = time.perf_counter()
        # the sample after the window bounds its last stretch
        time.sleep(2 * SMI_PERIOD_MS / 1000.0)
        with self._lock:
            samples = list(self.samples)
        return integrate(samples, self._t0, t1)

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)
        self._proc.stdout.close()


def open_meter(uuid: Optional[str] = None, index: int = 0):
    """NVML's counter where the card gives it, else the sampler."""
    try:
        return NvmlMeter(uuid=uuid, index=index)
    except (OSError, AttributeError, NvmlError):
        return SmiMeter(index=index)
