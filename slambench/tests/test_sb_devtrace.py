"""The profiler reading: busy time as the union of device intervals
inside the stretch, kernels counted, idle gaps named by the host label."""

from slambench import devtrace


class _Ev:
    def __init__(self, name, dev, s, e):
        self._v = (name, dev, s, e)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]


class _Prof:
    def __init__(self, evs):
        kr = type("KR", (), {"events": lambda self: evs})()
        self.profiler = type("P", (), {"kineto_results": kr})()


def test_read():
    evs = [_Ev(devtrace.STRETCH, False, 0, 1000),
           _Ev(devtrace.HAND_IN, False, 0, 100),
           _Ev(devtrace.WAIT, False, 500, 1000),
           _Ev("k1", True, 100, 300), _Ev("k2", True, 200, 400),
           _Ev("Memcpy HtoD", True, 400, 450), _Ev("k1", True, 700, 900),
           _Ev("k3", True, 1500, 1600),           # outside the stretch
           _Ev(devtrace.HAND_IN, True, 0, 900)]   # a GPU user annotation
    r = devtrace.read(_Prof(evs), 2)
    assert r["kernels"] == 3
    assert abs(r["busy_s"] - 550e-9) < 1e-15
    assert abs(r["window_s"] - 1000e-9) < 1e-15
    name, secs = r["device_ops"][0]
    assert name == "k1" and abs(secs - 400e-9) < 1e-15
    gaps = [(n, round(x * 1e9)) for n, x in r["idle_gaps"]]
    assert gaps[0] == ("slambench.host", 250)
    assert sorted(gaps[1:]) == [("slambench.hand_in", 100),
                                ("slambench.wait", 100)]

