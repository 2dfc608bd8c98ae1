"""``gcn_tpu_torch/utils/chain_timing.py`` on the CPU: its arithmetic and
its chaining, with the CUDA events and the spin kernel replaced by fakes
(a CUDA event has no CPU mode), and its gather chain's function."""

import numpy as np
import pytest
import torch

from gcn_tpu_torch.utils import chain_timing as ct


class _FakeCuda:
    """``torch.cuda``'s events, spin kernel and synchronize: each event
    pair reads the next of ``times`` ms."""

    def __init__(self, times):
        self.times = list(times)
        self.calls = []
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self):
                fake.calls.append("record")

            def elapsed_time(self, end):
                return fake.times.pop(0)

        self.Event = Event

    def _sleep(self, cycles):
        self.calls.append(("sleep", cycles))

    def synchronize(self):
        self.calls.append("sync")


@pytest.fixture
def fake_cuda(monkeypatch):
    def install(times):
        fake = _FakeCuda(times)
        for name in ("Event", "_sleep", "synchronize"):
            monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
        return fake
    return install


def test_chain_ms_feeds_each_call_the_previous_rows(fake_cuda):
    fake = fake_cuda([3.0, 1.0, 2.0, 5.0, 4.0])
    seen = []

    def fn(x):
        seen.append(x.clone())
        return torch.cat([x + 1, x + 100])

    x = torch.zeros(2, 1)
    assert ct.chain_ms(fn, x, reps=5) == 3.0
    # warm-up calls on x, then five chained calls on the first 2 rows
    assert len(seen) == ct.WARMUP_CALLS + 5
    assert all(torch.equal(s, x) for s in seen[:ct.WARMUP_CALLS])
    assert [float(s[0, 0]) for s in seen[ct.WARMUP_CALLS:]] == [0, 1, 2, 3, 4]
    assert ("sleep", ct.SPIN_CYCLES) in fake.calls


def test_chain_ms_without_spin_and_device_ms(fake_cuda):
    fake = fake_cuda([1.0, 9.0, 2.0])
    assert ct.chain_ms(lambda v: v, torch.ones(3, 2), reps=3,
                       spin=False) == 2.0
    assert not any(isinstance(c, tuple) for c in fake.calls)
    calls = []
    fake_cuda([4.0, 6.0])
    assert ct.device_ms(lambda: calls.append(1), reps=2) == 5.0
    assert len(calls) == ct.WARMUP_CALLS + 2


def test_rates_from_the_chain(monkeypatch):
    monkeypatch.setattr(ct, "chain_ms", lambda fn, x, reps=30, *a, **k: 2.0)
    # 8 index rows of 1,000 at n = 1,000: 2 ms / 8,000 rows
    assert ct.gather_ns_per_row(1000, 4, device="cpu") == \
        pytest.approx(2e6 / 8000)
    assert ct.gather_ns_per_row(400_000, 4, device="cpu") == \
        pytest.approx(2e6 / (5 * 400_000))
    # 512 MB read and written in 2 ms
    assert ct.stream_gb_per_s(1, device="cpu") == \
        pytest.approx(2 * 2**20 / 2e-3 / 1e9)


def test_gather_chain_sums_the_gathered_rows():
    step, x0, rows = ct.gather_chain(50, 3, idx_len=150, seed=1,
                                     device="cpu")
    assert rows == 150
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 3)).astype(np.float32) * 0.01
    idx = rng.integers(0, 50, (3, 50))
    want = (x[idx[0]] + x[idx[1]] + x[idx[2]]) * np.float32(0.999)
    np.testing.assert_allclose(step(x0).numpy(), want, rtol=1e-6)
    step16, x16, _ = ct.gather_chain(50, 3, torch.bfloat16, idx_len=150,
                                     device="cpu")
    assert step16(x16).dtype == torch.bfloat16


def test_bounds_and_work():
    assert ct.spmm_work(10, 3, 5, 7, 4) == (10 * 8 + 3 * 4 + 5 * 16 + 7 * 16,
                                            2 * 10 * 4)
    ms, by = ct.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = ct.bound_ms(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_cpu_runs_give_no_device_time_and_a_cpu_stamp():
    calls = []
    assert ct.on_device_ms("cpu", lambda v: calls.append(v) or v,
                           torch.ones(2, 2)) is None
    assert ct.on_device_ms("cpu", lambda: calls.append(0)) is None
    assert len(calls) == 2
    meta = ct.stamp("cpu")
    assert meta["device"] == "cpu" and "card" not in meta


def test_smi_line_takes_the_first_card(monkeypatch):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100, 700.00 W\n"

    monkeypatch.setattr(ct.subprocess, "run", lambda *a, **k: Done())
    assert ct.smi_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    Done.stdout = ""
    with pytest.raises(RuntimeError):
        ct.smi_line()
