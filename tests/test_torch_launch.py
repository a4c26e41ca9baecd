"""The launch plane of the port (``repro_torch.launch``: ``mesh``,
``steps``, ``train``, ``serve``) and sharded checkpoints, on gloo ranks.

Each mesh's rank group is spawned once (``torch.multiprocessing``, start
method ``spawn``, a file-based rendezvous, one CPU thread a rank) and runs
every drive; the single-device steps run in the test process on the same
inputs.

* On ``(1, 1)``, ``(2, 2)`` and ``(4, 2)`` ``(data, model)`` meshes, the
  ``train`` cell (``build_cell``, ``materialize``, ``run_cell``) of
  smollm-135m and of mixtral-8x7b (reduced, float32, capacity factor 8 so
  that no group drops a token) equals the single-device step: loss and
  ``grad_norm`` within 1e-5 relative, every parameter after the step
  within 1e-5 in norm relative to the parameter (‖Δ‖/‖p‖: Adam's first
  step moves each weight by ±lr·g/|g|, so a gradient whose true value is
  below its last-ulp noise moves by ±lr either way; an elementwise bound
  would test that noise), and Adam's first moment after the step leaf
  by leaf within 1e-5 in norm relative to the leaf: at the first step it
  is 0.1 times the clipped gradient, so it holds each leaf's gradient to
  its size where the parameters see only its sign.  The updated
  parameters keep their layouts.
* On ``(4, 2)`` the loss and every gradient leaf of two more train cells
  equal the single device's (the same config, its heads padded for the
  model axis, on one device) within 1e-5 relative in norm, a leaf whose
  single-device gradient is rounding noise around zero (below 1e-6 of the
  largest leaf's: the attention key bias) below that floor too:
  smollm-135m with 9 query and 3 KV heads, padded to 10 and 5, so each
  model rank's 5 query heads straddle KV groups (rank 0 reads KV heads 0,
  0, 1, 1, 2), and a vocabulary of 500 padded to 512, whose padded
  columns lie on the second model rank; and qwen2-vl-2b, whose loss
  slices the logits (``logits[:, s_vis:]``).  The vocab-parallel cross
  entropy alone (``layers.cross_entropy_loss`` on DTensor logits: batch
  over data and vocab over model, or batch over both mesh dims) equals
  the plain loss and its logits' gradient within 1e-5, the padded
  columns' gradient exactly zero.  ``adamw_update`` on DTensor leaves
  (sharded, replicated, a gradient in another layout) keeps every local
  shard's storage and placements and equals the update of the whole
  tensors within 1e-6 relative.
* On ``(2, 2)``, the ``decode`` cells (the module's parameters and
  caches as DTensors) equal single-device decode logits (the same config,
  its heads padded for the model axis, on one device) over three steps
  within 1e-5 of max |logit|, in every layout of the cache on the model
  axis: qwen3-0.6b and zamba2-1.2b (KV heads over the model axis);
  smollm-135m with 9 query and 3 KV heads, padded to 10 and 5, so its
  cache is sharded over T and the softmax split over the model ranks;
  whisper-large-v3's self- and cross-attention caches over the heads, and
  with one KV head over T; and smollm-135m with a sliding window of 2, so
  the ring buffer's two slots lie on the two model ranks and the third
  step overwrites the first slot (at the first step the second rank holds
  no valid slot).
* A checkpoint saved on ``(2, 2)`` restores onto ``(2, 1)`` (ranks 0 and
  1 of the same group) with ``restore(shardings=)`` to the saved arrays
  bit for bit, each leaf in the new mesh's layout; a checkpoint written by
  the reference's ``checkpoint.save`` restores onto the same mesh bit for
  bit.
* ``make_production_mesh`` raises without a process group and on a
  process group of the wrong size.
* ``python -m repro_torch.launch.train|serve --reduced --device cpu`` run
  and print the reference's JSON keys (read from the reference's
  source, ``Trainer.run``'s result and ``launch/serve.py``'s summary);
  ``serve`` refuses the encoder-decoder family, as the reference's does.
"""

import datetime
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.registry import ShapeSpec

MESHES = ((1, 1), (2, 2), (4, 2))
TRAIN = ShapeSpec("train_small", 16, 8, "train")
DECODE = ShapeSpec("decode_small", 16, 8, "decode")
TRAIN_ARCHS = ("smollm-135m", "mixtral-8x7b")
# decode cells: (arch, overrides); the cache's layout on the (2, 2) mesh's
# model axis in the comments
DECODE_CELLS = {
    "qwen3-0.6b": ("qwen3-0.6b", {}),                            # heads
    "zamba2-1.2b": ("zamba2-1.2b", {}),                          # heads
    "smollm-135m": ("smollm-135m", dict(num_heads=9, num_kv_heads=3)),  # T
    "whisper-large-v3": ("whisper-large-v3", {}),                # heads
    "whisper-over-t": ("whisper-large-v3", dict(num_kv_heads=1)),  # T
    "window": ("smollm-135m", dict(window=2)),                   # T, a ring
}
# gradient cells on the (4, 2) mesh: query heads straddling KV groups and
# a padded vocabulary; the VLM's sliced logits
GRAD_MESH = (4, 2)
GRAD_CELLS = {"straddle": ("smollm-135m", dict(num_heads=9, num_kv_heads=3,
                                               vocab_size=500)),
              "vlm": ("qwen2-vl-2b", {})}
NOISE = 1e-6            # a gradient leaf below this share of the largest
CE_SHAPE, CE_VOCAB = (8, 4, 512), 500
DECODE_STEPS = 3
DECODE_MESH = (2, 2)
CKPT_MESH, RESTORE_MESH = (2, 2), (2, 1)
RTOL = 1e-5
JOIN_S = 300.0
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _overrides(arch):
    ov = {"compute_dtype": "float32"}
    if arch.startswith("mixtral"):
        ov["capacity_factor"] = 8.0
    return ov


def _full(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def cache_leaf(cache, key):
    """A decode cache's (L, B, T, H, D) attention leaf ``key``."""
    for part in ("self", "shared"):
        if part in cache:
            return cache[part][key]
    return cache[key]


def _decode_tokens(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (DECODE.global_batch, 1)).astype(np.int32)
            for _ in range(DECODE_STEPS)]


# ---------------------------------------------------------------------------
# Rank groups
# ---------------------------------------------------------------------------

def _rank_main(rank, ranks, init_file, out_dir, shape, ckpt_dir, ref_ckpt):
    import torch.distributed as dist

    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.launch.steps import (
        _map_specs, build_cell, materialize, run_cell)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves, leaves_with_paths

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_debug_mesh(*shape, device_type="cpu")
    out = {"train": {}, "decode": {}}
    for arch in TRAIN_ARCHS:
        cell = build_cell(arch, TRAIN, mesh, overrides=_overrides(arch),
                          reduced=True)
        (state, batch), _ = materialize(cell, "cpu", seed=0)
        new, metrics = run_cell(cell, state, batch)
        out["train"][arch] = {
            "tokens": _full(batch["tokens"]),
            "labels": _full(batch["labels"]),
            "loss": float(_full(metrics["loss"])),
            "grad_norm": float(_full(metrics["grad_norm"])),
            "params": {"/".join(map(str, p)): _full(v)
                       for p, v in leaves_with_paths(new.params)},
            "mu": {"/".join(map(str, p)): _full(v)
                   for p, v in leaves_with_paths(new.opt.mu)},
            "layouts_kept": all(
                tuple(a.placements) == tuple(b.placements)
                for a, b in zip(leaves(new.params), leaves(state.params))),
        }
        if shape == CKPT_MESH and arch == TRAIN_ARCHS[0]:
            ckpt.save(ckpt_dir, 1, new)
            out["restore"] = _restore_on_submesh(rank, ckpt_dir, ref_ckpt)
    if shape == GRAD_MESH:
        out["grads"] = {name: _grad_cell(mesh, arch, ov)
                        for name, (arch, ov) in GRAD_CELLS.items()}
        out["ce"] = _vocab_parallel_ce(mesh)
        out["adamw"] = _sharded_adamw(mesh)
    for name in (DECODE_CELLS if shape == DECODE_MESH else ()):
        arch, overrides = DECODE_CELLS[name]
        cell = build_cell(arch, DECODE, mesh,
                          overrides={**_overrides(arch), **overrides},
                          reduced=True)
        args, _ = materialize(cell, "cpu", seed=0)
        (module, cache), cross = args[:2], args[4:]
        got = {"logits": [], "cross": [tuple(_full(t) for t in kv)
                                       for kv in cross],
               "kv_placements": [tuple(cache_leaf(cache, k).placements)
                                 for k in ("k", "v")]}
        for step, toks in enumerate(_decode_tokens(cell.cfg.vocab_size)):
            tok = distribute(torch.as_tensor(toks), cell.args[2].sharding)
            pos = distribute(torch.full((DECODE.global_batch,), step,
                                        dtype=torch.int32),
                             cell.args[3].sharding)
            lo, cache = run_cell(cell, module, cache, tok, pos, *cross)
            got["logits"].append(_full(lo))
        out["decode"][name] = got
    try:
        make_production_mesh(device_type="cpu")
        out["production_mesh"] = "built"
    except ValueError as e:
        out["production_mesh"] = str(e)
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _grad_cell(mesh, arch, overrides):
    """The loss and gradients of ``arch``'s train cell (reduced, float32,
    ``overrides``) on ``mesh``, whole, with the batch it ran on."""
    from repro_torch.launch.steps import build_cell, materialize, run_cell
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cell = build_cell(arch, TRAIN, mesh, overrides=dict(
        _overrides(arch), **overrides), reduced=True)
    (state, batch), _ = materialize(cell, "cpu", seed=0)
    grad_cell = cell._replace(fn=lambda st, b: value_and_grad(
        cell.model.loss_fn, st.params, b))
    loss, grads = run_cell(grad_cell, state, batch)
    return {"batch": {k: v.full_tensor().detach().clone()
                      for k, v in batch.items()},
            "loss": float(_full(loss)),
            "grads": {"/".join(map(str, p)): _full(g)
                      for p, g in leaves_with_paths(grads)}}


def _ce_inputs():
    rng = np.random.default_rng(4)
    logits = torch.as_tensor(rng.standard_normal(CE_SHAPE) * 3,
                             dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, CE_VOCAB, CE_SHAPE[:2]),
                             dtype=torch.int64)
    labels[::3, 1] = -100                       # ignored positions
    return logits, labels


def _vocab_parallel_ce(mesh):
    """``cross_entropy_loss`` and its logits' gradient on DTensor logits
    of two layouts, whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import cross_entropy_loss

    logits, labels = _ce_inputs()
    out = {}
    for name, lay in (("vocab", (Shard(0), Shard(2))),
                      ("batch", (Shard(0), Shard(0)))):
        x = distribute_tensor(logits, mesh, lay).requires_grad_(True)
        y = distribute_tensor(labels, mesh, (Shard(0), lay[1])
                              if lay[1] == Shard(0) else (Shard(0),
                                                          Replicate()))
        loss = cross_entropy_loss(x, y, CE_VOCAB)
        loss.backward()
        out[name] = {"loss": float(_full(loss)), "grad": _full(x.grad),
                     "placements": tuple(loss.placements)}
    return out


def _adamw_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.as_tensor(rng.standard_normal((8, 6)),
                                 dtype=torch.float32),
            "b": torch.as_tensor(rng.standard_normal(6),
                                 dtype=torch.float32)}


def _sharded_adamw(mesh):
    """``adamw_update`` on DTensor leaves: ``w`` sharded on both mesh dims,
    ``b`` replicated, ``w``'s gradient replicated; whole results, and
    whether every local shard kept its storage and every leaf its
    placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

    lays = {"w": (Shard(0), Shard(1)), "b": (Replicate(), Replicate())}
    params, grads = _adamw_tree(5), _adamw_tree(6)
    mu, nu = _adamw_tree(7), _adamw_tree(8)
    nu = {k: v.abs() for k, v in nu.items()}
    d = {name: {k: distribute_tensor(t[k], mesh, lays[k]) for k in t}
         for name, t in (("p", params), ("mu", mu), ("nu", nu))}
    g = {"w": distribute_tensor(grads["w"], mesh, (Replicate(), Replicate())),
         "b": distribute_tensor(grads["b"], mesh, lays["b"])}
    step = distribute_tensor(torch.tensor(3, dtype=torch.int32), mesh,
                             (Replicate(), Replicate()))
    ptrs = [t.to_local().data_ptr() for tree in d.values()
            for t in tree.values()] + [step.to_local().data_ptr()]
    new_p, opt, _ = adamw_update(AdamWConfig(lr=1e-2, warmup_steps=2),
                                 d["p"], g, OptState(mu=d["mu"], nu=d["nu"],
                                                     step=step))
    trees = (new_p, opt.mu, opt.nu)
    kept = ptrs == [t.to_local().data_ptr() for tree in trees
                    for t in tree.values()] + [opt.step.to_local().data_ptr()]
    return {"kept": kept and all(
        tuple(tree[k].placements) == lays[k] for tree in trees for k in tree),
        "p": {k: _full(v) for k, v in new_p.items()},
        "mu": {k: _full(v) for k, v in opt.mu.items()},
        "nu": {k: _full(v) for k, v in opt.nu.items()}}


def _restore_on_submesh(rank, ckpt_dir, ref_ckpt):
    """On ranks 0 and 1 of the checkpoint's group, as a ``(2, 1)`` mesh:
    the checkpoint and the reference-written one restored with that
    mesh's layouts (full arrays), and whether every leaf took its
    layout."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.steps import _map_specs, build_cell, materialize
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import leaves, leaves_with_paths

    # every rank of the group builds the mesh (its process groups are
    # made collectively); ranks 2 and 3 hold no part of it
    sub = DeviceMesh("cpu", torch.arange(RESTORE_MESH[0] * RESTORE_MESH[1])
                     .reshape(RESTORE_MESH), mesh_dim_names=("data", "model"))
    if rank >= RESTORE_MESH[0] * RESTORE_MESH[1]:
        return None
    cell = build_cell(TRAIN_ARCHS[0], TRAIN, sub,
                      overrides=_overrides(TRAIN_ARCHS[0]), reduced=True)
    (state, _), _ = materialize(cell, "cpu", seed=0)
    layouts = _map_specs(lambda a: a.sharding, cell.args[0])
    got = ckpt.restore(ckpt_dir, 1, state, shardings=layouts)
    ref = ckpt.restore(ref_ckpt, 7, state, shardings=layouts)

    def full(tree):
        return {"/".join(map(str, p)): _full(v)
                for p, v in leaves_with_paths(tree)}

    return {"own": full(got), "ref": full(ref), "layouts_kept": all(
        tuple(v.placements) == tuple(s.placements)
        for v, s in zip(leaves(got), leaves(layouts)))}


def _run_groups(shapes, ckpt_dir, ref_ckpt) -> dict:
    """Every mesh's rank group, all started at once; rank 0's results."""
    out = {}
    tmps = {s: tempfile.mkdtemp(prefix="launch_") for s in shapes}
    ctxs = {s: mp.start_processes(
        _rank_main, args=(s[0] * s[1], os.path.join(tmps[s], "pg"), tmps[s],
                          s, ckpt_dir, ref_ckpt),
        nprocs=s[0] * s[1], join=False, start_method="spawn")
        for s in shapes}
    deadline = time.monotonic() + JOIN_S
    try:
        for s, ctx in ctxs.items():
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    raise AssertionError(f"mesh {s} did not finish in "
                                         f"{JOIN_S} s")
            with open(os.path.join(tmps[s], "rank0.pkl"), "rb") as f:
                out[s] = pickle.load(f)
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return out


def _reference_checkpoint(path):
    """A smollm-135m train state written by the reference's
    ``checkpoint.save`` at step 7."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.models import build_model
    from repro.train import checkpoint as jckpt
    from repro.train.train_step import init_train_state

    cfg = dataclasses.replace(get_config("smollm-135m", reduced=True),
                              compute_dtype="float32")
    params, _ = build_model(cfg).init(jax.random.PRNGKey(3))
    jckpt.save(path, 7, init_train_state(params))


def _cli(module, *args, package="repro_torch"):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-m", f"{package}.launch.{module}",
                             *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


TRAIN_ARGS = ("--arch", "smollm-135m", "--reduced", "--steps", "4",
              "--segments", "2", "--docs-per-segment", "32", "--seq", "32",
              "--batch", "2")
SERVE_ARGS = ("--arch", "qwen3-0.6b", "--reduced", "--requests", "2",
              "--max-new", "4", "--prompt-len", "4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    ckpt_dir, ref_ckpt = str(tmp / "ckpt"), str(tmp / "ref_ckpt")
    _reference_checkpoint(ref_ckpt)
    clis = {
        "train": _cli("train", *TRAIN_ARGS, "--device", "cpu"),
        "serve": _cli("serve", *SERVE_ARGS, "--device", "cpu"),
    }
    groups = _run_groups(MESHES, ckpt_dir, ref_ckpt)
    outs = {}
    for name, proc in clis.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        outs[name] = stdout
    return dict(groups=groups, ckpt=ckpt_dir, ref_ckpt=ref_ckpt, cli=outs)


def _single_train(arch, tokens, labels):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_from_module
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import leaves_with_paths

    cfg = dataclasses.replace(get_config(arch, reduced=True, tp=1),
                              **_overrides(arch))
    model = build_model(cfg, device="cpu", seed=0)
    state = init_train_state(tree_from_module(model))
    new, m = make_train_step(model.loss_fn, AdamWConfig())(
        state, {"tokens": torch.as_tensor(tokens),
                "labels": torch.as_tensor(labels)})
    def named(tree):
        return {"/".join(map(str, p)): v.numpy()
                for p, v in leaves_with_paths(tree)}

    return (float(m["loss"]), float(m["grad_norm"]), named(new.params),
            named(new.opt.mu))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_train_cell_equals_single_device(runs, shape, arch):
    got = runs["groups"][shape]["train"][arch]
    loss, gnorm, params, mu = _single_train(arch, got["tokens"],
                                            got["labels"])
    assert abs(got["loss"] - loss) <= RTOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= RTOL * abs(gnorm)
    for name, want_tree in (("params", params), ("mu", mu)):
        assert set(got[name]) == set(want_tree)
        for k, want in want_tree.items():
            err = np.linalg.norm((got[name][k] - want).ravel())
            assert err <= RTOL * np.linalg.norm(want.ravel()), (name, k)
    assert got["layouts_kept"]


def _single_grads(arch, overrides, batch):
    """The loss and gradients of ``arch``'s reduced float32 config with
    ``overrides``, its heads padded for the (4, 2) mesh's model axis, on
    one device."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_from_module
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import leaves_with_paths

    cfg = dataclasses.replace(
        get_config(arch, reduced=True, tp=GRAD_MESH[1]),
        **_overrides(arch), **overrides)
    model = build_model(cfg, device="cpu", seed=0)
    loss, grads = value_and_grad(model.loss_fn, tree_from_module(model),
                                 batch)
    return cfg, float(loss), {"/".join(map(str, p)): g.numpy()
                              for p, g in leaves_with_paths(grads)}


@pytest.mark.parametrize("name", GRAD_CELLS)
def test_grad_cell_equals_single_device(runs, name):
    from repro_torch.models.transformer import _attn_config

    got = runs["groups"][GRAD_MESH]["grads"][name]
    arch, overrides = GRAD_CELLS[name]
    cfg, loss, want = _single_grads(arch, overrides, got["batch"])
    if name == "straddle":
        # each model rank's 5 query heads straddle groups of G = 2, and
        # the padded vocabulary's last columns lie on the second rank
        acfg = _attn_config(cfg)
        local = acfg.heads_padded // GRAD_MESH[1]
        assert (acfg.heads_padded, acfg.kv_heads_padded) == (10, 5)
        assert local % (acfg.heads_padded // acfg.kv_heads_padded) != 0
        assert want["embedding"].shape[0] > cfg.vocab_size
    assert abs(got["loss"] - loss) <= RTOL * abs(loss)
    assert set(got["grads"]) == set(want)
    floor = NOISE * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got["grads"][k]
        assert g.shape == w.shape, k
        if np.abs(w).max() <= floor:
            assert np.abs(g).max() <= floor, k
            continue
        assert np.linalg.norm(g - w) <= RTOL * np.linalg.norm(w), k


@pytest.mark.parametrize("layout", ["vocab", "batch"])
def test_vocab_parallel_cross_entropy_equals_plain(runs, layout):
    from torch.distributed.tensor import Replicate

    from repro_torch.models.layers import cross_entropy_loss

    got = runs["groups"][GRAD_MESH]["ce"][layout]
    logits, labels = _ce_inputs()
    x = logits.clone().requires_grad_(True)
    loss = cross_entropy_loss(x, labels, CE_VOCAB)
    loss.backward()
    want = x.grad.numpy()
    loss = float(loss.detach())
    assert abs(got["loss"] - loss) <= RTOL * abs(loss)
    assert np.linalg.norm(got["grad"] - want) <= RTOL * np.linalg.norm(want)
    # the padded columns stay masked: no gradient reaches them
    assert not got["grad"][..., CE_VOCAB:].any()
    assert got["placements"] == (Replicate(), Replicate())


def test_sharded_adamw_keeps_storages_and_equals_whole(runs):
    from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

    got = runs["groups"][GRAD_MESH]["adamw"]
    assert got["kept"]
    nu = {k: v.abs() for k, v in _adamw_tree(8).items()}
    params, opt, _ = adamw_update(
        AdamWConfig(lr=1e-2, warmup_steps=2), _adamw_tree(5), _adamw_tree(6),
        OptState(mu=_adamw_tree(7), nu=nu,
                 step=torch.tensor(3, dtype=torch.int32)))
    for name, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
        for k, want in tree.items():
            want = want.numpy()
            assert np.abs(got[name][k] - want).max() <= 1e-6 * np.abs(
                want).max(), (name, k)


# the cache's placement on the model axis (mesh dim 1) of each cell
DECODE_LAYOUT = {"qwen3-0.6b": 3, "zamba2-1.2b": 3, "smollm-135m": 2,
                 "whisper-large-v3": 3, "whisper-over-t": 2, "window": 2}


@pytest.mark.parametrize("name", DECODE_CELLS)
def test_decode_cell_equals_single_device(runs, name):
    import dataclasses

    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    arch, overrides = DECODE_CELLS[name]
    cfg = dataclasses.replace(
        get_config(arch, reduced=True, tp=DECODE_MESH[1]),
        **_overrides(arch), **overrides)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, long_window=None)
    model = build_model(cfg, device="cpu", seed=0)
    cache = model.init_cache(DECODE.global_batch, DECODE.seq_len,
                             dtype=torch.float32)
    got = runs["groups"][DECODE_MESH]["decode"][name]
    # the (L, B, T, H, D) cache over the batch on data and over heads (3)
    # or T (2) on the model axis
    want_pl = (Shard(1), Shard(DECODE_LAYOUT[name]))
    assert got["kv_placements"] == [want_pl, want_pl]
    if name == "window":
        assert cache_leaf(cache, "k").shape[2] == 2 < DECODE_STEPS
    cross = [torch.as_tensor(t) for kv in got["cross"] for t in kv]
    assert len(got["logits"]) == DECODE_STEPS
    for step, toks in enumerate(_decode_tokens(cfg.vocab_size)):
        pos = torch.full((DECODE.global_batch,), step, dtype=torch.int32)
        want, cache = model.decode_step(cache, torch.as_tensor(toks), pos,
                                        *([tuple(cross)] if cross else []))
        want = want.numpy()
        assert np.max(np.abs(got["logits"][step] - want)) <= RTOL * np.max(
            np.abs(want)), step


def test_restore_reshards_a_checkpoint_onto_a_new_mesh(runs):
    got = runs["groups"][CKPT_MESH]["restore"]
    with np.load(os.path.join(runs["ckpt"], "step_1", "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    assert set(got["own"]) == set(saved)
    for k, v in saved.items():
        assert got["own"][k].dtype == v.dtype
        assert got["own"][k].tobytes() == v.tobytes(), k
    assert got["layouts_kept"]
    # the saved state is the (2, 2) mesh's post-step parameters
    post = runs["groups"][CKPT_MESH]["train"][TRAIN_ARCHS[0]]["params"]
    for k, v in post.items():
        assert saved["params/" + k].tobytes() == v.tobytes(), k


def test_reference_checkpoint_restores_onto_a_mesh(runs):
    got = runs["groups"][CKPT_MESH]["restore"]["ref"]
    with np.load(os.path.join(runs["ref_ckpt"], "step_7",
                              "arrays.npz")) as z:
        saved = {k: z[k] for k in z.files}
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert got[k].tobytes() == v.tobytes(), k


def test_production_mesh_needs_its_rank_count(runs):
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    for shape in MESHES:
        msg = runs["groups"][shape]["production_mesh"]
        assert "needs 256 ranks" in msg, msg
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(2, 2, device_type="cpu")


def _reference_keys(fn) -> set:
    """The string keys of the dict literal ``fn`` returns, else of its
    last one (the reference's JSON summaries, read without running
    JAX)."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    returned = [n.value for n in ast.walk(tree)
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    dicts = returned or [n for n in ast.walk(tree) if isinstance(n, ast.Dict)]
    return {k.value for k in dicts[-1].keys}


def test_train_cli_prints_reference_keys(runs):
    from repro.train.trainer import Trainer

    out = runs["cli"]["train"]
    got = json.loads(out.split("gate decisions:")[0])
    assert set(got) == _reference_keys(Trainer.run) - {"state"}
    assert got["steps"] == 4
    gates = json.loads(out.split("gate decisions:")[1])
    assert [g["event"] for g in gates] == ["gate", "gate"]


def test_serve_cli_prints_reference_keys(runs):
    from repro.launch import serve as jserve

    got = json.loads(runs["cli"]["serve"])
    assert set(got) == _reference_keys(jserve.main)
    assert got["all_done"] and got["new_tokens"] == 8


def test_serve_cli_refuses_encdec():
    proc = _cli("serve", "--arch", "whisper-large-v3", "--reduced",
                "--device", "cpu")
    _, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "enc-dec serving" in err
