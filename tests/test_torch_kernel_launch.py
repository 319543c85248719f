"""``backend.launch``, the one way the port calls a hand-written kernel:
the library of ``csrc/<kernel>.cu`` loaded with the caller's signature
table, the device current while the entry runs, the device's current
stream as the last argument, and a nonzero cudaError_t raised with the
caller's message. Runs on the CPU with a stub library and stub
``torch.cuda`` calls; nothing is compiled."""

import contextlib
import types

import pytest
import torch

from tpu_operator_torch.kernels import build
from tpu_operator_torch.workloads import backend, hbm_probe
from tpu_operator_torch.workloads import flashattention as fa

STREAM = 0x5EED
DEVICE = torch.device("cuda", 3)


@pytest.mark.parametrize("kernel, signatures, entry, what", [
    ("triad", hbm_probe._SIGNATURES, "triad_f32", "triad kernel"),
    ("flash_attention", fa._SIGNATURES, "flash_attention_fwd_bf16",
     "flash attention kernel"),
    ("flash_attention_bwd", fa._BWD_SIGNATURES, "flash_attention_bwd_bf16",
     "flash attention backward kernel"),
])
def test_launch_calls_the_entry_on_the_device_stream_and_raises_its_error(
        monkeypatch, kernel, signatures, entry, what):
    calls, current, rc = [], [], [0]

    def entry_fn(*args):
        calls.append((args, list(current)))
        return rc[0]

    def load(name, sigs):
        assert (name, sigs) == (kernel, signatures)
        return types.SimpleNamespace(**{entry: entry_fn})

    @contextlib.contextmanager
    def device(dev):
        current.append(dev)
        yield
        current.pop()

    def current_stream(dev):
        assert current == [dev] == [DEVICE]
        return types.SimpleNamespace(cuda_stream=STREAM)

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)

    # one distinct value for each argument before the stream
    args = tuple(range(10, 10 + len(signatures[entry][1]) - 1))
    backend.launch(kernel, signatures, entry, DEVICE, *args, what=what)
    assert calls == [(args + (STREAM,), [DEVICE])]
    assert current == []

    rc[0] = 700
    with pytest.raises(RuntimeError) as err:
        backend.launch(kernel, signatures, entry, DEVICE, *args, what=what)
    assert str(err.value) == f"{what} launch failed: cudaError 700"
    assert len(calls) == 2 and current == []
