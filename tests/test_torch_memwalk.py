"""The live bytes ``DispatchWalk`` counts (``roofline/dispatch_walk.py``)
on hand-sized steps with exact answers, at granule 1 and at the CUDA
caching allocator's 512 B.

Every case runs on the CPU and on the meta device, with the same answer.
A float32 tensor of 1,000 elements is ``R`` = 4,000 B (4,096 B at granule
512), a float32 scalar ``r`` = 4 B (512 B).  ``x`` is held (the step's
argument): it is never the step's own.  Above 1 MiB the mark is held to
within 1/4096 of itself (the walk sweeps once a slack of growth), with
far fewer sweeps than ops.
"""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.roofline.dispatch_walk import (
    CUDA_ALLOC_GRANULE, DispatchWalk, walk)

N = 1000
GRANULES = [1, CUDA_ALLOC_GRANULE]
DEVICES = ["cpu", "meta"]


def _round(n, g):
    return -(-n // g) * g


def _walk(fn, x, g):
    with DispatchWalk(hold=x, granule=g, trace=True) as w:
        fn(x)
    return w, [(op, live) for op, _, _, _, _, live in w.trace]


@pytest.fixture(params=DEVICES)
def x(request):
    return torch.ones(N, device=request.param)


@pytest.mark.parametrize("g", GRANULES)
def test_freed_intermediate_leaves_the_count(x, g):
    R, big = _round(4 * N, g), _round(40 * N, g)

    def step(x):
        y = x.repeat(10)           # 10 R, freed after its sum
        s = y.sum()
        del y
        return x * s

    w, live = _walk(step, x, g)
    assert [op for op, _ in live] == ["aten.repeat.default",
                                      "aten.sum.default",
                                      "aten.mul.Tensor"]
    assert w.temp_peak_bytes == big + _round(4, g)
    assert (w.peak_op, w.peak_index) == ("aten.sum.default", 1)
    assert live[-1][1] == _round(4, g) + R        # y is gone
    assert w.held_bytes == R
    assert w.peak_bytes == R + big + _round(4, g)


@pytest.mark.parametrize("g", GRANULES)
def test_view_and_in_place_add_nothing(x, g):
    R = _round(4 * N, g)

    def step(x):
        y = x * 2
        v = y.view(10, 100)
        v.add_(1)
        x.add_(1)                  # in place on the held argument
        y.mul_(v.view(-1))
        return y[3:].t()

    w, live = _walk(step, x, g)
    assert [b for _, b in live] == [R] * len(live)
    assert w.temp_peak_bytes == R and w.held_bytes == R


@pytest.mark.parametrize("g", GRANULES)
def test_saved_activation_lives_until_its_backward(x, g):
    R, r = _round(4 * N, g), _round(4, g)

    def step(x):
        w = x.detach().requires_grad_(True)
        a = torch.sin(w)
        b = torch.sin(a)           # saves a for its backward
        del a
        loss = b.sum()
        del b
        (grad,) = torch.autograd.grad(loss, [w])
        return grad

    w, live = _walk(step, x, g)
    ops = [op for op, _ in live]
    assert ops[:4] == ["aten.detach.default", "aten.sin.default",
                       "aten.sin.default", "aten.sum.default"]
    # the backward's first op: a (its name deleted), the loss and its
    # seed gradient
    assert live[4] == ("aten.ones_like.default", R + 2 * r)
    # sin(a)'s backward: cos(a), then the gradient of a
    assert live[6:8] == [("aten.cos.default", 2 * R + 2 * r),
                         ("aten.mul.Tensor", 3 * R + 2 * r)]
    # once that node ran, a is freed: cos(w) replaces it and cos(a)
    assert live[8] == ("aten.cos.default", 2 * R + 2 * r)
    assert w.temp_peak_bytes == 3 * R + 2 * r


LAYERS = 3


def _layers(x, ckpt):
    def layer(h):
        return torch.sin(torch.sin(h))

    w = x.detach().requires_grad_(True)
    h = w
    for _ in range(LAYERS):
        h = checkpoint(layer, h, use_reentrant=False) if ckpt else layer(h)
    (grad,) = torch.autograd.grad(h.sum(), [w])
    return grad


@pytest.mark.parametrize("g", GRANULES)
def test_checkpoint_lowers_the_peak_by_the_activations_it_drops(x, g):
    """Each layer saves its inner ``sin`` for its backward; checkpointed,
    it saves its input alone and recomputes the inner one in its
    backward.  The peak falls in the last layer's backward: without
    checkpoints the other ``LAYERS - 1`` inner activations are still
    live there, with them one recomputed."""
    R = _round(4 * N, g)
    plain, _ = _walk(lambda x: _layers(x, False), x, g)
    ckpt, live = _walk(lambda x: _layers(x, True), x, g)
    assert plain.temp_peak_bytes - ckpt.temp_peak_bytes == (LAYERS - 1) * R
    # the recomputation is walked: each layer's inner sin runs again
    assert sum(op == "aten.sin.default" for op, _ in live) == 3 * LAYERS


@pytest.mark.parametrize("g,want", [(1, 12), (CUDA_ALLOC_GRANULE, 512)])
def test_twelve_bytes_count_a_granule(x, g, want):
    with DispatchWalk(granule=g) as w:
        torch.empty(3, dtype=torch.int32, device=x.device)
    mem = w.memory()
    assert mem["temp_peak_bytes"] == mem["peak_bytes"] == want
    assert mem["peak_op"] == "aten.empty.memory_format"


def test_a_held_module_holds_its_parameters(x):
    """A decode cell's first argument is its module: its parameters are
    held, not the step's own when an op first reads them."""
    lin = torch.nn.Linear(N, 8, device=x.device)
    with DispatchWalk(hold=(lin, x)) as w:
        lin(x)
    assert w.held_bytes == 4 * (N * 8 + 8) + 4 * N
    assert w.temp_peak_bytes == 4 * 8


def test_walk_terms_unchanged_by_the_live_bytes():
    """The FLOPs and HBM bytes of a product: what the walk counted before
    it counted live bytes."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out, s = walk(torch.mm, a, b)
    assert s["matmul_flops"] == 2 * 8 * 16 * 4
    assert s["hbm_bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert s["memory"]["held_bytes"] == 4 * (8 * 16 + 16 * 4)
    assert s["memory"]["temp_peak_bytes"] == out.numel() * 4


def test_trace_file_marks_the_peak(tmp_path):
    x = torch.ones(N)
    with DispatchWalk(hold=x, trace=True) as w:
        torch.sin(torch.sin(x)).sum()
    path = tmp_path / "step.trace.txt"
    w.write_trace(str(path))
    lines = path.read_text().splitlines()
    assert lines[0].startswith("# granule 1 B; held 4000 B")
    body = lines[2:]
    assert len(body) == w.ops == 3
    marked = [ln for ln in body if ln.endswith("<- peak")]
    assert len(marked) == 1
    assert marked[0].split("\t")[:2] == [str(w.peak_index), w.peak_op]
    assert body[0].split("\t")[-1] == "4000"


def test_growing_live_bytes_sweep_once_a_slack(x, monkeypatch):
    """Above 1 MiB the walk sweeps only when its running total passes the
    mark by 1/4096 of it: 2,000 small results kept alive one op after
    another over a 2 MiB base sweep far fewer times than there are ops,
    and the mark stays within that share below the true one."""
    from repro_torch.roofline import dispatch_walk

    sweeps = []
    real = DispatchWalk._sweep
    monkeypatch.setattr(DispatchWalk, "_sweep",
                        lambda self: sweeps.append(self.ops) or real(self))
    base, n, size = 1 << 21, 2000, 64
    keep = []
    with DispatchWalk(hold=x, granule=1) as w:
        keep.append(torch.empty(base // 4, device=x.device))
        for _ in range(n):
            keep.append(x[:size // 4] + 1)
    true = base + n * size
    assert true - (true >> dispatch_walk.SWEEP_SLACK_SHIFT) \
        <= w.temp_peak_bytes <= true
    assert 0 < len(sweeps) < n // 4
