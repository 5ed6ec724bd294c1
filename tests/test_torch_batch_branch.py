"""The batch engine's keyframe branch as ONE batched branch over the lanes that insert.

``nislam_torch.core.slam._branch_body_lanes`` is body k of the batch
engine's graphs: the keyframe branch over the k lanes that insert in a
frame, gathered on the device (JAX's vmapped insert and vmapped
``deferred_loop_search``).  Held here, at the golden size (64×96, three
lanes, the worlds of seeds 1, 2 and 5 on ``tests/test_torch_batch.py``'s
loop, lane b starting b frames later, so that 1, 2 or 3 lanes insert in a
frame):

- frame by frame, the track body over all lanes, then body k on a copy of
  the state, against the kept eager step (``BatchSlamEngine._step``: the
  same tracking, then each inserting lane's ``_insert_keyframe(search=
  False)`` and each stored lane's ``deferred_loop_search``, one lane after
  another) bit for bit: every state leaf and the packed outputs, for k =
  1, 2 and 3, on four workloads: a small ring that evicts (pending matches
  voided and compacted), ``eviction: drop`` with a bank that fills
  (lanes whose keyframe is dropped gathered beside lanes that store),
  ``coarse_scale: 2`` (the coarse-to-fine search) and the online canvas
  with stored images (each lane's canvas retires and inserts);
- the gathered lanes are the inserting ones in ascending order, and the
  ``flags`` kernel's plain version in its batch mode takes slot k − 1;
- ``peak_stats``' pin of the blocks per response gives a response the
  block partition of a launch over one lane's responses, whatever the
  batch;
- against JAX's batch engine (its vmapped ``slam_step(defer_loop_search=
  True)`` and vmapped ``deferred_loop_search``), from the same state
  (``state_from_numpy``), a chunk in which all three lanes store and find
  loops: decisions exact, poses within 2e-3, PSRs within rtol 5e-4;
- on a card (``gpu`` marker, skipped here): body k against k lane
  branches, bit for bit (its keyframe filters lane by lane: cuFFT rounds
  a lane's transforms in a batch otherwise than alone).

On the CPU the batched search's registrations and rotations run lane by
lane (``lanes=k``: ``nislam_torch.ops.fft.by_lane``): MKL vectorizes a
transform over a strided axis across the batch, so a lane's bits would
otherwise depend on the lanes batched with it.  Everything else (the
gathers, the masked writes, the per-lane sorts and argmaxes) runs batched
as on the card.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import nislam_torch.core.chunk_graph as cg
from nislam_torch.core.slam import _branch_body_lanes, _track_body, map_state, state_leaves, unpack_step_output
from nislam_torch.core.track_graph import CHAIN
from nislam_torch.kernels.launch import block_ranges
from nislam_torch.ops.peak_stats import lane_blocks
from nislam_torch.parallel import make_batch_engine
from nislam_torch.utils.synthetic import heading_loop_path, make_world, render_sequence

from test_torch_batch_graph import LANES, _config, _same_bits

torch.set_num_threads(1)  # see test_torch_batch.py

H, W = 64, 96
FRAMES = 48
WORKLOADS = ("ring", "drop", "coarse", "online")
POSE_ATOL = 2e-3
PSR_RTOL = 5e-4


def _workload_config(name: str):
    config = _config("drop" if name == "drop" else "ring")
    if name == "ring":  # 6 slots: the ring evicts the keyframes of pending matches, which are voided
        return dataclasses.replace(config, map=dataclasses.replace(config.map, keyframe_capacity=6))
    if name == "coarse":
        return dataclasses.replace(config, loop_closure=dataclasses.replace(config.loop_closure, coarse_scale=2))
    if name == "online":  # a 24-slot ring whose evictions the canvas retires
        return dataclasses.replace(
            config, map=dataclasses.replace(config.map, keyframe_capacity=24, store_images=True),
            map_stitcher=dataclasses.replace(config.map_stitcher, stitch_map=True, online=True, canvas_size=512))
    return config


@pytest.fixture(scope="module")
def seqs():
    """Lane b: the loop from its frame b on, so the lanes' keyframes fall
    on different frames."""
    path = heading_loop_path(FRAMES + LANES - 1, step=3.5, start=(256.0, 256.0), tail=8)
    return np.stack([render_sequence(make_world(512, 3.0, seed=s), H, W, path)[b:b + FRAMES]
                     for b, s in enumerate((1, 2, 5))])


def _body_frame(engine, states, feats):
    """One tracked frame of every lane from ``states`` as the batch frame
    graph runs it, eagerly: the track body, its carry, then body k over
    the k lanes that insert → (states, packed outputs (B, 17), k)."""
    s = map_state(states, torch.clone)
    kw = dict(config=engine.config, cf_ops=engine.cf_ops, camera=engine.camera)
    img_u, fft, polar = feats
    b = types.SimpleNamespace(img_u=img_u, polar=polar, bank_count=s.bank.count,
                              **{n: getattr(s.track, n) for n in CHAIN})
    carry, outs = _track_body(b, **kw)
    for name, value in carry.items():
        getattr(s.track, name).copy_(value)
    k = int(outs["flags"][:, 0].sum())
    x = types.SimpleNamespace(img_u=img_u, fft=fft, polar=polar, tracked=outs["tracked"], packed=outs["packed"])
    if k:
        _branch_body_lanes(s, x, k, **kw)
    return s, x.packed, k


def _first_difference(a, b) -> str:
    for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b), strict=True)):
        if not _same_bits(x, y):
            return f"state leaf {i}: max abs diff {float((x.float() - y.float()).abs().max())}"
    return ""


@pytest.fixture(scope="module", params=WORKLOADS)
def lockstep(request, seqs):
    """A workload frame by frame: body k on a copy of the state against
    the eager step from the same state → per k, the frames compared and
    whether each held bit for bit (the first difference named), with what
    the frames exercised."""
    engine = make_batch_engine(_workload_config(request.param), LANES, device="cpu")
    feats = engine._features(seqs)
    states = engine.init_states()
    engine._step(states, tuple(x[0] for x in feats), [False] * LANES)
    by_k = {k: [] for k in range(1, LANES + 1)}
    seen = dict(found=0, dropped=0, voided=0, evicted=0)
    for i in range(1, FRAMES):
        f = tuple(x[i] for x in feats)
        before = states.pending.count.clone()
        got_states, got, k = _body_frame(engine, states, f)
        want = engine._step(states, f, [True] * LANES)
        if k:
            diff = _first_difference(got_states, states)
            if not _same_bits(got, want.pack()):
                diff = diff or f"packed outputs: {(got - want.pack()).abs().max()}"
            by_k[k].append((i, diff))
            out = unpack_step_output(got)
            seen["found"] += int(out.loop_found.sum())
            seen["dropped"] += int((out.inserted & (out.keyframe_slot < 0)).sum())
            seen["voided"] += int((states.pending.count < before + out.loop_found.to(torch.int32)).sum())
    seen["evicted"] = int(states.bank.overflow.sum())
    return types.SimpleNamespace(name=request.param, by_k=by_k, seen=seen)


@pytest.mark.parametrize("k", range(1, LANES + 1))
def test_body_k_equals_lane_branches(lockstep, k):
    """Body k over k gathered lanes equals k lane branches and their
    deferred searches bit for bit, on every frame where k lanes insert."""
    frames = lockstep.by_k[k]
    assert frames, f"{lockstep.name}: no frame with {k} inserting lanes"
    bad = [(i, diff) for i, diff in frames if diff]
    assert not bad, f"{lockstep.name}, k = {k}: {bad[:3]}"
    if k == LANES:
        seen = lockstep.seen
        if lockstep.name == "drop":
            assert seen["dropped"] > 0
        else:
            assert seen["found"] > 0
        if lockstep.name in ("ring", "online"):
            assert seen["evicted"] > 0
        if lockstep.name == "ring":
            assert seen["voided"] > 0


def test_gathered_lanes_and_the_flags_batch_mode():
    """The lanes a body gathers are the inserting ones in ascending order;
    the flags step's batch mode takes slot k − 1 (a run counted there),
    none for k = 0, and stops when body k is not held."""
    gen = torch.Generator().manual_seed(3)
    for _ in range(50):
        insert = torch.rand(8, generator=gen) < 0.4
        k = int(insert.sum())
        lanes = torch.argsort((~insert).to(torch.int32), stable=True)[:k]
        assert lanes.tolist() == torch.nonzero(insert).flatten().tolist()
    ctl = torch.zeros(cg.CTL_WORDS, dtype=torch.int32)
    flags = torch.tensor([[True, True], [False, False], [True, False]])
    ctl[cg.I] = 4
    assert cg._flags(ctl, flags, (0, 1), by_count=True) == {1}
    assert int(ctl[cg.STOP]) == 0 and int(ctl[cg.NEXT]) == 5 and ctl[cg.RUNS:cg.RUNS + 3].tolist() == [0, 1, 0]
    assert cg._flags(ctl, torch.zeros(3, 2, dtype=torch.bool), (0,), by_count=True) == set()
    assert int(ctl[cg.STOP]) == 0 and ctl[cg.RUNS:cg.RUNS + 3].tolist() == [0, 1, 0]
    assert cg._flags(ctl, torch.ones(3, 2, dtype=torch.bool), (0, 1), by_count=True) == set()
    assert int(ctl[cg.STOP]) == 1 and int(ctl[cg.NEXT]) == 4 and ctl[cg.RUNS:cg.RUNS + 3].tolist() == [0, 1, 0]
    assert cg.outer_body((0, 2)) == (("track",), ("flags",), ("switch",), ("advance_copy",))
    assert cg.outer_body(()) == (("track",), ("flags",), ("advance_copy",))


@pytest.mark.parametrize("shape,per_lane", [((480, 640), 16), ((360, 241), 8), ((360, 480), 8), ((120, 160), 16),
                                            ((480, 640), 2), ((64, 96), 128)])
def test_pin_keeps_each_response_partition(shape, per_lane):
    """``lane_blocks`` pins each response of a batch of k lanes' responses
    to the block partition that a launch over one lane's gives it (its
    Σg and Σg² split the same way), for any k; without the pin a batch
    changes it."""
    h, w = shape
    want = block_ranges(per_lane, h, w)
    for k in range(1, 9):
        g = torch.empty((k, per_lane, h, w), device="meta")
        assert block_ranges(k * per_lane, h, w, blocks=lane_blocks(g, k)) == want, k
    assert lane_blocks(torch.empty((3, h, w), device="meta"), 1) is None
    if block_ranges(8 * per_lane, h, w) == want:
        assert want[0] == 1 or block_ranges(8 * per_lane, h, w)[0] == want[0]
    with pytest.raises(ValueError, match="do not split"):
        lane_blocks(torch.empty((5, h, w), device="meta"), 2)


def test_batched_branch_matches_jax_batch_engine(seqs):
    """From JAX's state after frames [0, 24), the port's chunk program over
    frames [24, 48) (the track body and body k per frame, no solve)
    against JAX's batch engine over the same chunk (its vmapped step with
    the loop search deferred, its vmapped deferred search): decisions and
    slots exact, poses within 2e-3, PSRs within rtol 5e-4."""
    import jax
    import jax.numpy as jnp

    from nislam_torch.core.slam import state_from_numpy
    from nislam_tpu.parallel.batch import make_batch_engine as make_jax_batch_engine

    import test_torch_batch

    cfg = test_torch_batch._config()
    je = make_jax_batch_engine(cfg, batch=LANES)
    js, _ = je.run_chunk(je.init_states(), jnp.asarray(seqs[:, :24]))
    start = jax.tree.map(np.asarray, js)
    js, jo = je.run_chunk(js, jnp.asarray(seqs[:, 24:48]))
    jo = jax.tree.map(np.asarray, jo)

    engine = make_batch_engine(_config(), LANES, device="cpu")
    states = state_from_numpy(start, torch.device("cpu"))
    states, outs = engine.run_chunk(states, seqs[:, 24:48])
    o = unpack_step_output(outs.pack().numpy())
    for name in ("tracked", "inserted", "loop_found", "frame_id", "keyframe_slot", "loop_slot", "loop_eligible"):
        np.testing.assert_array_equal(getattr(o, name), np.asarray(getattr(jo, name)), err_msg=name)
    np.testing.assert_allclose(o.pose, jo.pose, atol=POSE_ATOL)
    np.testing.assert_allclose(o.response, jo.response, rtol=PSR_RTOL)
    stored = o.keyframe_slot >= 0
    assert (stored.sum(axis=0) >= 2).any() and o.loop_found.any()
    k = o.inserted.sum(axis=0)
    assert set(engine.frame_graph._branches) == set(k[k > 0].tolist())
    np.testing.assert_array_equal(states.pending.count.numpy(), np.asarray(js.pending.count))
    np.testing.assert_array_equal(states.bank.count.numpy(), np.asarray(js.bank.count))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: body k is captured and launched only on a card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_body_k_on_the_card(cuda, seqs, name):
    """On the card, body k against k lane branches from the same state,
    frame by frame, bit for bit in every leaf and output, for k = 1, 2, 3.
    cuFFT rounds a lane's transforms in a batch otherwise than alone, so
    body k computes each lane's keyframe filters at one lane's shapes; the
    batched search's results (argmax shifts, thresholds) come out the
    lanes' own."""
    engine = make_batch_engine(_workload_config(name), LANES, device=cuda)
    feats = engine._features(torch.from_numpy(seqs).to(cuda))
    states = engine.init_states()
    engine._step(states, tuple(x[0] for x in feats), [False] * LANES)
    ks = set()
    for i in range(1, FRAMES):
        f = tuple(x[i] for x in feats)
        got_states, got, k = _body_frame(engine, states, f)
        want = engine._step(states, f, [True] * LANES)
        if k:
            ks.add(k)
            diff = _first_difference(got_states, states)
            assert not diff and _same_bits(got, want.pack()), f"{name} frame {i} k = {k}: {diff or 'outputs'}"
    assert ks == {1, 2, 3}
