"""A CUDA graph capture acted out on the CPU, for the ``test_torch_*``
files: inside the capture a host read of a tensor's value raises, as the
card's capture does."""

import contextlib
import threading

import pytest
import torch


class _Capturing:
    """A CUDA graph capture acted out on the CPU: inside ``graph``, on the
    capturing thread, every read of a tensor's value by the host raises
    as the card's capture does, and ``torch.cuda.is_current_stream_capturing``
    is true; streams, events and the graph object do nothing."""

    READS = ("item", "__bool__", "__int__", "__float__", "tolist", "numpy",
             "cpu", "nonzero")

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
        stream = type("Stream", (), {
            "wait_stream": lambda *a: None, "wait_event": lambda *a: None})
        graph = type("Graph", (), {
            "__init__": lambda self, **kw: None,
            "instantiate": lambda self: None, "replay": lambda self: None,
            "raw_cuda_graph": lambda self: 0})
        for name, value in (("Stream", lambda *a: stream()),
                            ("current_stream", lambda *a: stream()),
                            ("stream", lambda s: contextlib.nullcontext()),
                            ("CUDAGraph", graph), ("graph", self.graph)):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(torch.Tensor, "record_stream", lambda *a: None)
        monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: t)

    @contextlib.contextmanager
    def graph(self, g, pool=None, stream=None, capture_error_mode=None):
        me = threading.get_ident()

        def on_this_thread(real, here):
            # the capture is the capturing thread's alone, as in the
            # card's thread_local mode: other threads read as before
            def call(*a, **kw):
                if threading.get_ident() == me:
                    return here(*a, **kw)
                return real(*a, **kw)
            return call

        def refuse(*a, **kw):
            raise RuntimeError("CUDA error: operation not permitted when "
                               "stream is capturing")
        with pytest.MonkeyPatch.context() as mp:
            for name in self.READS:
                mp.setattr(torch.Tensor, name,
                           on_this_thread(getattr(torch.Tensor, name),
                                          refuse))
            mp.setattr(torch, "nonzero", on_this_thread(torch.nonzero,
                                                        refuse))
            for name in ("is_initialized", "is_current_stream_capturing"):
                mp.setattr(torch.cuda, name, on_this_thread(
                    getattr(torch.cuda, name), lambda: True))
            yield
