"""The energy meter and its fallback, each with a stand-in for the card."""
import ctypes
import sys

import pytest

from benchkit import energy


class Fn:
    """A library function: callable, and takes ``argtypes`` / ``restype``."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class FakeNvml:
    """Stands in for ``libnvidia-ml.so.1``: a counter that a test moves."""

    def __init__(self, energy_rc=0, uuid_rc=0):
        self.mj = 1_000_000
        self.energy_rc, self.uuid_rc = energy_rc, uuid_rc
        self.shut = 0
        self.by_index = []
        for name in dir(type(self)):
            if name.startswith("nvml"):
                setattr(self, name, Fn(getattr(self, name)))

    def nvmlInit_v2(self):
        return 0

    def nvmlShutdown(self):
        self.shut += 1
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, ref):
        return self.uuid_rc

    def nvmlDeviceGetHandleByIndex_v2(self, index, ref):
        self.by_index.append(index)
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, ref):
        ref._obj.value = self.mj
        return self.energy_rc

    def nvmlDeviceGetName(self, handle, buf, size):
        ctypes.memmove(buf, b"NVIDIA H100 80GB HBM3\0", 22)
        return 0

    def nvmlDeviceGetPowerManagementLimit(self, handle, ref):
        ref._obj.value = 700000
        return 0


def test_nvml_counter_gives_joules_over_the_window():
    lib = FakeNvml()
    m = energy.NvmlMeter(uuid="GPU-x", lib=lib)
    assert m.describe() == ("NVIDIA H100 80GB HBM3", 700.0)
    m.start()
    lib.mj += 2_500_250
    assert m.stop() == pytest.approx(2500.25)
    m.close()
    m.close()
    assert lib.shut == 1


def test_nvml_falls_back_to_the_index_and_refuses_a_missing_counter():
    lib = FakeNvml(uuid_rc=13)
    energy.NvmlMeter(uuid="GPU-x", index=2, lib=lib).close()
    assert lib.by_index == [2]
    lib = FakeNvml(energy_rc=3)          # NVML_ERROR_NOT_SUPPORTED
    with pytest.raises(energy.NvmlError):
        energy.NvmlMeter(lib=lib)
    assert lib.shut == 1


def test_integrate_holds_power_piecewise_linear():
    samples = [(0.0, 100.0), (1.0, 300.0), (2.0, 300.0)]
    assert energy.integrate(samples, 0.0, 2.0) == pytest.approx(500.0)
    assert energy.integrate(samples, 0.5, 1.5) == pytest.approx(275.0)
    assert energy.integrate(samples, -1.0, 0.0) == pytest.approx(100.0)
    assert energy.integrate(samples, 2.0, 4.0) == pytest.approx(600.0)
    with pytest.raises(ValueError):
        energy.integrate([], 0.0, 1.0)


def test_sampler_integrates_a_child_process_readings():
    fake = [sys.executable, "-u", "-c",
            "import time\nfor _ in range(400):\n"
            "    print('250.0'); time.sleep(0.01)"]
    m = energy.SmiMeter(cmd=fake)
    try:
        import time
        time.sleep(0.3)
        m.start()
        time.sleep(0.5)
        joules = m.stop()
    finally:
        m.close()
    assert m._proc.poll() is not None
    assert joules == pytest.approx(250.0 * 0.5, rel=0.1)
