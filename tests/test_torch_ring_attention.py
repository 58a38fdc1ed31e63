"""Sequence parallelism on the port: ring attention over ``sp`` held against
the JAX package's, in gloo worlds of the port on the CPU.

One 4-rank world (``testing.join_cpu_world``) runs the port's
``ring_attention_sharded`` on the cases of the JAX package's
``tests/test_parallel.py::TestRingAttention`` and
``tests/test_segment_attention.py`` (causal and not, packed against
unpacked, a length of 30 on a ring of 4, all-pad trailing shards, on
``{"sp": 4}`` and ``{"dp": 2, "sp": 2}``), and a 3-rank world the rings of 3
(30, and a nondivisible 31). The JAX package's ``ring_attention_sharded``
runs the same numpy inputs on a CPU mesh of as many devices in the test
process: outputs within 2e-5 and the gradients of ``sum(out · g)`` within
1e-4, its tests' tolerances; each ring of the whole world also equals,
bitwise, the one-process seam (``ring_attention_local``) that the card's
check uses. The same world builds the transformer on ``{"dp": 2, "sp": 2}``
and ``{"tp": 2, "sp": 2}``: the logits of a ``TextPipeline`` slab at L = 46
against the JAX model on the same meshes (2e-5), one AdamW step's loss,
gradients and parameters against the JAX package's (1e-5), and a
checkpoint saved under ``dp × sp`` resharded onto ``dp`` and back, bitwise.
``attention="plain"``/``"flash"`` on sp attend the whole sequence, gathered:
the slab's logits on ``dp2 × sp2``, ``sp4`` (L = 46, a padded last block)
and ``sp2`` (a world of 2 ranks) against the JAX model with plain attention
on the same mesh (2e-5), and one AdamW step on ``dp2 × sp2`` and ``sp2``
(1e-5). The plain versions of the flash kernels with key-side segment ids are held
against the JAX package's Pallas kernels (``interpret=True``) on one
off-diagonal block pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tensorflowonspark_tpu import tfrecord
from tensorflowonspark_tpu.data import TextPipeline, Tokenizer
from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu.ops import flash_attention as jflash
from tensorflowonspark_tpu.parallel.ring_attention import plain_attention as jplain
from tensorflowonspark_tpu.parallel.ring_attention import ring_attention_sharded as jring
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.parallel import ring_attention as ra

from torch_world_util import run_world

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, dtype="float32")
SP_MESHES = {"dp2_sp2": {"dp": 2, "sp": 2}, "tp2_sp2": {"tp": 2, "sp": 2}}
#: meshes of whole-sequence ``plain``/``flash`` attention (``sp2`` in a
#: world of 2 ranks)
WHOLE_MESHES = {"dp2_sp2": {"dp": 2, "sp": 2}, "sp4": {"sp": 4}, "sp2": {"sp": 2}}


def _jmesh(axes):
    """A JAX CPU mesh of as many devices as ``axes`` needs."""
    n = int(np.prod(list(axes.values())))
    if jax.device_count() < n:
        pytest.skip("needs {} cpu devices".format(n))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())), tuple(axes))


def _packed(b, l, seed, segs):
    """The JAX test's packed case: random q/k/v ``[b, 2, l, 16]``, each row
    ``len(segs)`` sequences back to back (ids 1..n) and a pad tail (id 0)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, 2, l, 16)).astype(np.float32) for _ in range(3))
    seg = np.zeros((b, l), np.int32)
    spans, off = [], 0
    for i, n in enumerate(segs, start=1):
        seg[:, off:off + n] = i
        spans.append((off, off + n))
        off += n
    return q, k, v, seg, spans


def _dense(b, l, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, 2, l, 16)).astype(np.float32) for _ in range(3)) + (None, None)


#: name: (ring axes, inputs (q, k, v, ids, spans), causal)
CASES4 = {
    "causal": ({"sp": 4}, _dense(2, 32, 0), True),
    "full": ({"sp": 4}, _dense(2, 32, 1), False),
    "dp2_sp2_causal": ({"dp": 2, "sp": 2}, _dense(2, 32, 2), True),
    "packed_causal": ({"sp": 4}, _packed(2, 64, 4, (11, 7, 20)), True),
    "packed_full": ({"sp": 4}, _packed(2, 64, 4, (11, 7, 20)), False),
    "nondivisible_causal": ({"sp": 4}, _dense(2, 30, 9), True),
    "nondivisible_full": ({"sp": 4}, _dense(2, 30, 9), False),
    "packed_nondivisible_causal": ({"sp": 4}, _packed(2, 30, 5, (11, 7, 9)), True),
    "packed_nondivisible_full": ({"sp": 4}, _packed(2, 30, 5, (11, 7, 9)), False),
    "all_pad_trailing": ({"sp": 4}, _packed(2, 32, 6, (11, 7)), True),
    "dp2_sp2_nondivisible": ({"dp": 2, "sp": 2}, _dense(2, 30, 10), True),
}
CASES3 = {
    "ring3_causal": ({"sp": 3}, _dense(2, 30, 11), True),
    "ring3_full": ({"sp": 3}, _dense(2, 30, 12), False),
    "ring3_packed_nondivisible": ({"sp": 3}, _packed(2, 31, 13, (11, 7, 9)), True),
}
ALL = dict(CASES4, **CASES3)


def _weights(q, seed=99):
    return np.random.default_rng(seed).standard_normal(q.shape).astype(np.float32)


def _jax_ring(name):
    """The JAX package's ring on the case's mesh: output and the gradients
    of ``sum(out · g)``."""
    axes, (q, k, v, seg, _), causal = ALL[name]
    mesh = _jmesh(axes)
    ids = None if seg is None else jnp.asarray(seg)
    g = jnp.asarray(_weights(q))

    @jax.jit
    def run(q, k, v):
        out, vjp = jax.vjp(lambda q, k, v: jring(q, k, v, mesh, causal=causal, segment_ids=ids), q, k, v)
        return out, vjp(g)

    out, grads = run(*(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(t) for t in grads]


def _spec(cases):
    return {"ring": ("job_ring", dict(cases={name: (axes, q, k, v, seg, causal, _weights(q))
                                            for name, (axes, (q, k, v, seg, _), causal) in cases.items()}))}


# -- the transformer on sp meshes ---------------------------------------------


def _slab(tmp, seq_len=46, batch_size=4):
    """The JAX test's packed ``TextPipeline`` slab (``test_model_axes.py``
    ``TestRingOnTextSlabs``)."""
    rng = np.random.default_rng(11)
    words = "ring attention shards long sequence slabs over devices".split()
    texts = [" ".join(rng.choice(words, size=max(2, int(rng.lognormal(2.2, 0.7))))) for _ in range(96)]
    path = str(tmp / "part-00000")
    with tfrecord.TFRecordWriter(path) as w:
        for t in texts:
            w.write(t.encode("utf-8"))
    pipe = TextPipeline([path], Tokenizer(kind="word", vocab_size=64), seq_len=seq_len, batch_size=batch_size,
                        seed=7)
    batch = next(iter(pipe))
    return {k: np.asarray(batch[k]).astype(np.int32) for k in ("tokens", "segment_ids", "positions")}


def _packed_batch(rows=8, l=24, seed=3):
    """``test_model_axes.py``'s packed batch: two sequences (ids 1, 2) and a
    pad tail; 23 inputs a row, so the second of two sp blocks is padded."""
    rng = np.random.default_rng(seed)
    s1, s2 = rng.integers(3, 64, 11).astype(np.int32), rng.integers(3, 64, 7).astype(np.int32)
    tokens, seg, pos = (np.zeros((rows, l), np.int32) for _ in range(3))
    tokens[:, :11], seg[:, :11], pos[:, :11] = s1, 1, np.arange(11)
    tokens[:, 11:18], seg[:, 11:18], pos[:, 11:18] = s2, 2, np.arange(7)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), jax.device_get(tree))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    model = jtransformer.create_model(attention="plain", **CFG)
    params = _np(jax.jit(jtransformer.make_init_fn(model, sample_len=16))(jax.random.PRNGKey(0))["params"])
    slab = _slab(tmp_path_factory.mktemp("slab"))
    logits = {}
    for name, axes in SP_MESHES.items():
        ring = jtransformer.create_model(mesh=_jmesh(axes), attention="ring", **CFG)
        logits[name] = np.asarray(jax.jit(ring.apply)({"params": params}, jnp.asarray(slab["tokens"]),
                                                      positions=jnp.asarray(slab["positions"]),
                                                      segment_ids=jnp.asarray(slab["segment_ids"])))
    plain_logits = {}
    for name, axes in WHOLE_MESHES.items():
        whole = jtransformer.create_model(mesh=_jmesh(axes), attention="plain", **CFG)
        plain_logits[name] = np.asarray(jax.jit(whole.apply)({"params": params}, jnp.asarray(slab["tokens"]),
                                                             positions=jnp.asarray(slab["positions"]),
                                                             segment_ids=jnp.asarray(slab["segment_ids"])))
    batch = _packed_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(model), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tx = optax.adamw(1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    return {"params": params, "slab": slab, "logits": logits, "plain_logits": plain_logits, "batch": batch,
            "loss": float(loss),
            "grads": convert.convert_variables({"params": _np(grads)}),
            "stepped": convert.convert_variables({"params": _np(optax.apply_updates(params, updates))})}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    a, b = str(tmp / "a"), str(tmp / "b")
    v, cfg = ref["params"], dict(CFG, attention="ring")
    spec = _spec(CASES4)
    for name, axes in SP_MESHES.items():
        spec["logits_" + name] = ("job_sp_logits", dict(variables=v, cfg=cfg, batch=ref["slab"], axes=axes))
        spec["step_" + name] = ("job_axes_step", dict(variables=v, cfg=cfg, batches=[ref["batch"]], axes=axes))
    spec.update(_whole_spec(ref, ("dp2_sp2", "sp4")))
    spec.update({
        "save_sp": ("job_axes_save", dict(root=a, variables=v, cfg=cfg, batch=ref["batch"], axes={"dp": 2, "sp": 2},
                                          step_no=1)),
        "save_dp": ("job_axes_save", dict(root=b, variables=v, cfg=cfg, batch=ref["batch"], axes={"dp": 4},
                                          step_no=1)),
        "sp_on_dp": ("job_axes_restore", dict(path=a + "/ckpt_1", variables=v, cfg=cfg, axes={"dp": 4})),
        "dp_on_sp": ("job_axes_restore", dict(path=b + "/ckpt_1", variables=v, cfg=cfg, axes={"dp": 2, "sp": 2})),
    })
    return run_world(tmp, spec)


def _whole_spec(ref, names):
    """Jobs of whole-sequence ``plain``/``flash`` attention on the meshes
    ``names``: the slab's logits, and one step where the mesh has dp or
    only 2 sp ranks."""
    spec = {}
    for impl in ("plain", "flash"):
        cfg = dict(CFG, attention=impl)
        for name in names:
            axes = WHOLE_MESHES[name]
            spec["whole_{}_{}".format(impl, name)] = ("job_sp_logits", dict(
                variables=ref["params"], cfg=cfg, batch=ref["slab"], axes=axes))
            if name != "sp4":
                spec["whole_step_{}_{}".format(impl, name)] = ("job_axes_step", dict(
                    variables=ref["params"], cfg=cfg, batches=[ref["batch"]], axes=axes))
    return spec


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("sp2"), _whole_spec(ref, ("sp2",)), world=2)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("ring3"), _spec(CASES3), world=3)


def _ranks(name, world, world3):
    return world3 if name in CASES3 else world


@pytest.mark.parametrize("name", sorted(ALL))
def test_ring_attention_sharded_matches_the_jax_package(world, world3, name):
    want, want_grads = _jax_ring(name)
    for r, got in enumerate(_ranks(name, world, world3)):
        got = got["ring"][name]
        np.testing.assert_allclose(got["out"].numpy(), want, atol=2e-5, err_msg="rank %d" % r)
        for which, g, w in zip("qkv", got["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, err_msg="rank %d d%s" % (r, which))


@pytest.mark.parametrize("name", sorted(n for n in ALL if "packed" in n or "pad" in n))
def test_packed_ring_matches_unpacked(world, world3, name):
    """The fence makes a packed ring the per-sequence attention on every
    real position, as the JAX test's unpacked oracle shows."""
    _, (q, k, v, seg, spans), causal = ALL[name]
    want = np.zeros(q.shape, np.float32)
    for lo, hi in spans:
        want[:, :, lo:hi] = np.asarray(jplain(*(jnp.asarray(t[:, :, lo:hi]) for t in (q, k, v)), causal=causal))
    real = seg[0] > 0
    for got in _ranks(name, world, world3):
        out = got["ring"][name]["out"].numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out[:, :, real], want[:, :, real], atol=2e-5)


def test_the_ring_equals_the_one_process_seam_bitwise(world, world3):
    """``ring_attention_local`` (the card's check runs the ring through it)
    makes the same launches and sums as a ring of ranks."""
    checked = 0
    for ranks in (world, world3):
        for got in ranks:
            for name, res in got["ring"].items():
                if "local" in res:
                    assert torch.equal(res["out"], res["local"]), name
                    checked += 1
    assert checked == 4 * 5 + 3 * 2  # the rings of the whole world whose L divides it


@pytest.mark.parametrize("name", sorted(SP_MESHES))
def test_sp_logits_match_the_jax_model_on_the_same_mesh(ref, world, name):
    real = ref["slab"]["segment_ids"] > 0
    blocks = {}
    for got in world:
        blocks[got["logits_" + name]["sp_index"]] = got["logits_" + name]["logits"].numpy()
        assert got["logits_" + name]["sp"] == 2
    logits = np.concatenate([blocks[0], blocks[1]], axis=1)
    np.testing.assert_allclose(logits[real], ref["logits"][name][real], atol=2e-5)


@pytest.mark.parametrize("name", sorted(SP_MESHES))
def test_one_adamw_step_on_sp_matches_the_jax_package(ref, world, name):
    """The loss is the mean over the global batch's real tokens on every
    rank (the sp blocks hold different counts: the last one is padded);
    the gradients are summed over sp and averaged over dp."""
    for r, got in enumerate(world):
        got = got["step_" + name]
        np.testing.assert_allclose(got["losses"], [ref["loss"]], atol=1e-5, rtol=0, err_msg="rank %d" % r)
        for key, want in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][key].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg="rank %d grad %s" % (r, key))
        for key, want in ref["stepped"].items():
            np.testing.assert_allclose(got["params"][key].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg="rank %d %s" % (r, key))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + "/" + str(k))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


@pytest.mark.parametrize("restored, saved", [("sp_on_dp", "save_sp"), ("dp_on_sp", "save_dp")])
def test_dp_sp_checkpoint_reshards_onto_dp_and_back_bitwise(world, restored, saved):
    """sp replicates the parameters: a ``dp2 × sp2`` checkpoint restores
    onto ``dp4`` and a ``dp4`` one onto ``dp2 × sp2`` byte for byte, and the
    two saves hold the same step (within 1e-5)."""
    want = world[0][saved]["tree"]
    assert world[0][saved]["verified"] == (True, "verified") and not world[0][saved]["gathers"]
    for r in world:
        got = r[restored]
        assert got["step"] == want["step"] == 1
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k], v), k
        for k, v in _flat(want["opt_state"]):
            assert torch.equal(dict(_flat(got["opt_state"]))[k], v), k
    other = world[0]["save_dp" if saved == "save_sp" else "save_sp"]["tree"]["params"]
    for k, v in want["params"].items():
        np.testing.assert_allclose(v.numpy(), other[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


# -- the kernels' plain versions with the keys' own ids ------------------------


def test_plain_versions_with_key_ids_match_the_pallas_kernels(monkeypatch):
    """One off-diagonal block pair of a ring hop (no causal mask, the keys'
    ids apart from the queries'): the port's plain versions against the
    JAX package's Pallas kernels in interpret mode, which read the two
    sides' ids from operands of their own (fed here by patching the
    helper that builds them from one id tensor)."""
    rng = np.random.default_rng(21)
    b, h, l, d = 2, 2, 32, 16
    q, k, v, do = (rng.standard_normal((b * h, l, d)).astype(np.float32) for _ in range(4))
    seg_q = np.repeat(np.array([[1] * 10 + [2] * 22]), b, 0).astype(np.int32)
    seg_k = np.repeat(np.array([[0] * 5 + [1] * 12 + [2] * 15]), b, 0).astype(np.int32)
    scale = 1.0 / np.sqrt(d)

    def seg_inputs(seg, bh, l_q, l_k):
        sq, sk = seg
        return (jnp.broadcast_to(sq[:, :, None], (bh, l_q, jflash._STAT_W)),
                jnp.broadcast_to(sk[:, None, :], (bh, jflash._STAT_W, l_k)))

    monkeypatch.setattr(jflash, "_seg_inputs", seg_inputs)
    ids = tuple(jnp.asarray(np.repeat(s, h, 0)) for s in (seg_q, seg_k))
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    o, lse = jflash._flash_fwd(jq, jk, jv, ids, scale, False, 16, 16, True)
    dq, dk, dv = jflash._flash_bwd(jq, jk, jv, ids, jdo, o, lse, scale, False, 16, 16, True)

    t = torch.as_tensor
    sq, sk = t(seg_q), t(seg_k)
    got_o, got_lse = fa.flash_fwd(t(q), t(k), t(v), sq, scale, False, h, seg_k=sk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, 0], atol=2e-5)
    lse_t = t(np.asarray(lse)[:, :, 0].copy())
    delta = (t(do) * t(np.asarray(o))).sum(-1)
    args = (t(q), t(k), t(v), sq, t(do), lse_t, delta, scale, False, h)
    np.testing.assert_allclose(fa.flash_bwd_dq(*args, seg_k=sk).numpy(), np.asarray(dq), atol=1e-4)
    got_dk, got_dv = fa.flash_bwd_dkv(*args, seg_k=sk)
    np.testing.assert_allclose(got_dk.numpy(), np.asarray(dk), atol=1e-4)
    np.testing.assert_allclose(got_dv.numpy(), np.asarray(dv), atol=1e-4)
    # the keys' ids matter: with the queries' on both sides the result moves
    assert not np.allclose(fa.flash_fwd(t(q), t(k), t(v), sq, scale, False, h)[0].numpy(), np.asarray(o),
                           atol=1e-3)


def test_visited_blocks_reads_the_keys_ids():
    seg_q = torch.tensor([[1] * 64 + [2] * 64])
    seg_k = torch.tensor([[2] * 128])
    assert fa.visited_blocks(seg_q, False, seg_k=seg_k).tolist() == [[[False, False], [True, True]]]
    assert fa.visited_blocks(seg_q, False).tolist() == [[[True, False], [False, True]]]


def test_hop_schedule_launches_n_n_plus_1_over_2_causal():
    """Under the causal mask member ``my`` takes its own block (causal)
    and the blocks before it (unmasked): n(n+1)/2 launches a direction."""
    hops = ra.hop_schedule(4, True)
    assert len(hops) == 10
    assert all(src <= my and (mask == (src == my)) for _, my, src, mask in hops)
    assert len(ra.hop_schedule(4, False)) == 16


def _sp_blocks(results, key, length):
    """The whole sequence's logits from the ranks' blocks (in sp order),
    the last block's padding cut off."""
    blocks = {}
    for got in results:
        blocks[got[key]["sp_index"]] = got[key]["logits"].numpy()
    return np.concatenate([blocks[i] for i in sorted(blocks)], axis=1)[:, :length]


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("name", sorted(WHOLE_MESHES))
def test_whole_sequence_attention_on_sp_matches_the_jax_model(ref, world, world2, impl, name):
    """``attention="plain"``/``"flash"`` on an sp mesh attend over the
    whole sequence, gathered, as the JAX package's ``plain`` does there:
    the slab's logits within 2e-5 of the JAX model on the same mesh (on
    ``sp4`` L = 46 does not divide: the last block is padded)."""
    ranks = world2 if name == "sp2" else world
    real = ref["slab"]["segment_ids"] > 0
    logits = _sp_blocks(ranks, "whole_{}_{}".format(impl, name), real.shape[1])
    np.testing.assert_allclose(logits[real], ref["plain_logits"][name][real], atol=2e-5)


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("name", ["dp2_sp2", "sp2"])
def test_one_adamw_step_of_whole_sequence_attention_on_sp_matches_the_jax_package(ref, world, world2, impl, name):
    """One AdamW step with ``plain``/``flash`` attention on an sp mesh (23
    inputs a row: sp does not divide them): the loss, the gradients and the
    stepped parameters within 1e-5 of the JAX package's."""
    for r, got in enumerate(world2 if name == "sp2" else world):
        got = got["whole_step_{}_{}".format(impl, name)]
        np.testing.assert_allclose(got["losses"], [ref["loss"]], atol=1e-5, rtol=0, err_msg="rank %d" % r)
        for key, want in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][key].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg="rank %d grad %s" % (r, key))
        for key, want in ref["stepped"].items():
            np.testing.assert_allclose(got["params"][key].numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg="rank %d %s" % (r, key))


def test_sequence_chunk_overlaps_one_target_and_pads_the_last_block():
    from tensorflowonspark_tpu_torch.parallel import sharding

    tokens = np.arange(1, 12, dtype=np.int32)[None].repeat(2, 0)  # L = 10 inputs
    batch = {"tokens": tokens, "segment_ids": np.ones_like(tokens)}
    blocks = [sharding.sequence_chunk(batch, i, 3) for i in range(3)]  # 4 inputs a block
    assert [b["tokens"][0].tolist() for b in blocks] == [[1, 2, 3, 4, 5], [5, 6, 7, 8, 9], [9, 10, 11, 0, 0]]
    assert blocks[2]["segment_ids"][0].tolist() == [1, 1, 1, 0, 0]
    assert blocks[2]["mask"][0].tolist() == [1, 1, 1, 0, 0] and blocks[0]["mask"].all()
    # the row's inputs ride with every block as a host int (the MoE route)
    assert [b["row_length"] for b in blocks] == [10] * 3 and type(blocks[0]["row_length"]) is int
    assert "row_length" not in sharding.sequence_chunk(batch, 0, 2)  # 5 + 5: no padding
    # every target of the row is counted once: block i's targets are tokens[:, 1:] of its chunk
    targets = np.concatenate([b["tokens"][:, 1:][b["mask"][:, 1:] > 0] for b in blocks])
    assert sorted(targets.tolist()) == sorted(tokens[:, 1:].ravel().tolist())
    assert sharding.sequence_chunk(batch, 0, 1) is batch


def test_ring_at_head_dim_320_matches_whole_sequence_plain_attention(monkeypatch):
    """``ring_attention_local`` on 4 members at D = 320 (the split-D
    kernels' own width: ``widen_heads`` pads nothing), its hops through the
    wrappers with f32 outputs (the split-D mirrors here), causal with
    packed segments: O, dq, dk and dv against the port's dense
    ``plain_attention`` over the whole sequence within 2e-5."""
    d, b, h = 320, 2, 2
    rng = np.random.default_rng(32)
    q, k, v, do = (rng.standard_normal((b, h, 96, d)).astype(np.float32) for _ in range(4))
    ids = np.zeros((b, 96), np.int32)
    ids[:, :30], ids[:, 30:71], ids[:, 71:90] = 1, 2, 3
    seg = torch.tensor(ids)

    def run(fn):
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        o = fn(tq, tk, tv)
        o.backward(torch.tensor(do))
        return o.detach(), tq.grad, tk.grad, tv.grad

    want = run(lambda *t: ra.plain_attention(*t, causal=True, segment_ids=seg))
    widths = []
    monkeypatch.setattr(fa, "widen_heads", lambda t: widths.append(fa.head_width(t.shape[-1]))
                        or fa._widen(t, fa.head_width(t.shape[-1])))
    monkeypatch.setattr(fa, "flash_fwd", lambda q, k, v, seg, scale, causal, heads, seg_k=None, out_dtype=None:
                        fa.flash_fwd_split_plain(q, k, v, seg, scale, causal, heads, seg_k=seg_k))
    monkeypatch.setattr(fa, "flash_bwd_dq", fa.flash_bwd_dq_split_plain)
    monkeypatch.setattr(fa, "flash_bwd_dkv", fa.flash_bwd_dkv_split_plain)
    got = run(lambda *t: ra.ring_attention_local(*t, 4, causal=True, segment_ids=seg))
    assert set(widths) == {320}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=name)
