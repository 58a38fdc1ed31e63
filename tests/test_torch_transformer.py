"""The port's transformer LM, weight converter and AdamW against the JAX
package's flax model and ``optax.adamw``, on the CPU. The JAX model's
variables go through ``convert.load_variables`` into the port's module;
both see the same packed batch (numpy, seeded); JAX's ``attention="flash"``
runs its Pallas kernels in interpret mode, the port's runs the kernels'
plain versions (the CPU path)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import transformer as jtransformer
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer
from tensorflowonspark_tpu_torch.train import optim

SMALL = dict(vocab_size=300, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)


def _packed_batch(b, length, vocab, seed, spans):
    """``[b, length + 1]`` packed rows: segments ``spans`` with per-segment
    positions, padding (id 0, token 0) after them."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, length + 1), np.int32)
    seg = np.zeros_like(tokens)
    pos = np.zeros_like(tokens)
    for i, (lo, hi) in enumerate(spans, start=1):
        tokens[:, lo:hi] = rng.integers(1, vocab, (b, hi - lo))
        seg[:, lo:hi] = i
        pos[:, lo:hi] = np.arange(hi - lo)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def _models(cfg, attention, seed=0):
    jmodel = jtransformer.create_model(dtype="float32", attention=attention, **cfg)
    variables = jax.jit(jtransformer.make_init_fn(jmodel, sample_len=8))(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, variables["params"])
    module = convert.load_variables(
        transformer.create_model(dtype="float32", attention=attention, **cfg), {"params": params}
    )
    return jmodel, params, module


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_converted_small_transformer_matches_logits_loss_and_grads():
    """Packed-batch logits with attention='flash', then the loss and every
    gradient through make_loss_fn: f32 sums in another order, 1e-4."""
    jmodel, params, module = _models(SMALL, "flash")
    batch = _packed_batch(2, 48, SMALL["vocab_size"], 0, ((0, 20), (20, 37), (37, 45)))
    tokens, seg, pos = (batch[k][:, :-1] for k in ("tokens", "segment_ids", "positions"))
    jlogits = jax.jit(lambda p, t, ps, sg: jmodel.apply({"params": p}, t, positions=ps, segment_ids=sg))(
        params, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(seg))
    logits = module(torch.as_tensor(tokens), positions=torch.as_tensor(pos),
                    segment_ids=torch.as_tensor(seg))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4)

    jloss_fn = jtransformer.make_loss_fn(jmodel)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    loss, metrics = transformer.make_loss_fn(module)(module, _torch_batch(batch))
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-4
    assert abs(float(metrics["perplexity"]) - float(jmetrics["perplexity"])) < 1e-3
    want = convert.convert_variables({"params": jax.tree.map(np.asarray, jgrads)})
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)


def test_converter_raises_on_unmatched_transformer_keys():
    _, params, module = _models(SMALL, "plain")
    extra = {"params": dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError, match="stray"):
        convert.convert_variables(extra, module)
    missing = {"params": {k: v for k, v in params.items() if k != "ln_f"}}
    with pytest.raises(KeyError, match="ln_f.weight"):
        convert.convert_variables(missing, module)
    odd = {"params": dict(params, lm_head={"table": np.zeros((2, 2), np.float32)})}
    with pytest.raises(KeyError, match="lm_head/table"):
        convert.convert_variables(odd, module)


def test_full_width_forward_loss_matches_at_short_length():
    """TransformerConfig's defaults (d_model 512, 6 layers, 8 heads, d_ff
    2048, vocab 32000), batch 1, L=128, f32, attention 'auto' (plain on the
    CPU on both sides). The loss, ~log(32000), is a mean of 127 terms each
    summed over 6 layers of f32 products of width up to 2048 in another
    order: 1e-4 absolute."""
    cfg = dict(vocab_size=32000, d_model=512, n_layers=6, n_heads=8, d_ff=2048, max_seq_len=2048)
    jmodel, params, module = _models(cfg, "auto", seed=1)
    batch = _packed_batch(1, 128, 32000, 1, ((0, 50), (50, 128)))
    jloss, _ = jax.jit(jtransformer.make_loss_fn(jmodel))(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        loss, _ = transformer.make_loss_fn(module)(module, _torch_batch(batch))
    assert abs(float(loss) - float(jloss)) < 1e-4, (float(loss), float(jloss))


def test_adamw_three_steps_match_optax():
    """Three optax.adamw(3e-4) steps on the small transformer: params and
    both moments within 1e-5."""
    jmodel, params, module = _models(SMALL, "plain", seed=2)
    batches = [_packed_batch(2, 32, SMALL["vocab_size"], s, ((0, 12), (12, 30))) for s in range(3)]
    tx = optax.adamw(3e-4)
    jstate = tx.init(params)
    jloss_fn = jtransformer.make_loss_fn(jmodel)
    jparams = params
    jgrad = jax.jit(jax.grad(lambda p, b: jloss_fn(p, b)[0]))
    for batch in batches:
        grads = jgrad(jparams, jax.tree.map(jnp.asarray, batch))
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

    opt = optim.adamw(3e-4)
    state = opt.init(dict(module.named_parameters()))
    loss_fn = transformer.make_loss_fn(module)
    for batch in batches:
        module.zero_grad()
        loss_fn(module, _torch_batch(batch))[0].backward()
        named = dict(module.named_parameters())
        opt.update(named, {n: p.grad for n, p in named.items()}, state)

    adam = jstate[0]
    assert state["count"] == int(adam.count) == 3
    for got, want in ((dict(module.named_parameters()), jparams), (state["mu"], adam.mu),
                      (state["nu"], adam.nu)):
        want = convert.convert_variables({"params": jax.tree.map(np.asarray, want)})
        for name, t in got.items():
            np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kwargs", [dict(moe_experts=4), dict(remat=True)])
def test_model_options_run(kwargs):
    """A mixture of experts and rematerialization build and take a
    forward and backward (their numerics against the JAX package:
    test_torch_moe.py, test_torch_model_axes.py)."""
    module = transformer.create_model(**dict(SMALL, **kwargs))
    loss, metrics = transformer.make_loss_fn(module)(module, {"tokens": torch.randint(0, 8, (2, 9))})
    loss.backward()
    assert torch.isfinite(loss) and all(p.grad is not None for p in module.parameters())
    assert ("moe_aux" in metrics) == bool(kwargs.get("moe_experts"))


def test_ring_attention_raises():
    """Once refused, now ported: ``attention="ring"`` without a mesh is a
    ring of one member, the flash call, and equals plain attention."""
    ring = transformer.create_model(attention="ring", generator=torch.Generator().manual_seed(0), **SMALL)
    plain = transformer.create_model(attention="plain", generator=torch.Generator().manual_seed(0), **SMALL)
    tokens = torch.randint(0, SMALL["vocab_size"], (2, 24), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(ring(tokens).numpy(), plain(tokens).numpy(), atol=2e-5)


@pytest.mark.parametrize("d", [320, 512])
def test_lm_at_one_wide_head_matches_the_jax_package(monkeypatch, d):
    """The port's transformer at one head of 320 and of 512 (``d_model`` =
    the head dim, ``n_heads 1``), 2 layers, narrow vocab and d_ff, with
    ``attention="flash"`` through the split-D kernels' plain mirrors on
    weights converted from the JAX model: the loss within 1e-5 and every
    gradient within 1e-5 of the JAX package's (its flash kernels in
    interpret mode), on a packed batch."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    cfg = dict(vocab_size=128, d_model=d, n_layers=2, n_heads=1, d_ff=256, max_seq_len=128,
               attention="flash", dtype="float32")
    jmodel = jtransformer.create_model(**cfg)
    params = jax.jit(jtransformer.make_init_fn(jmodel, sample_len=16))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.array(a), jax.device_get(params))
    rng = np.random.default_rng(d)
    tokens = rng.integers(1, cfg["vocab_size"], (2, 129)).astype(np.int32)
    seg = np.ones_like(tokens)
    seg[:, 50:] = 2
    seg[:, 120:] = 0
    pos = np.where(seg == 2, np.arange(tokens.shape[1]) - 50, np.arange(tokens.shape[1])).astype(np.int32)
    batch = {"tokens": tokens, "segment_ids": seg, "positions": pos}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtransformer.make_loss_fn(jmodel), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = convert.convert_variables({"params": jax.tree.map(np.asarray, jgrads)})

    launches = []
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **kw: launches.append("fwd") or fa.flash_fwd_split_plain(*a))
    monkeypatch.setattr(fa, "flash_bwd_dq", lambda *a, **kw: launches.append("dq") or fa.flash_bwd_dq_split_plain(*a))
    monkeypatch.setattr(fa, "flash_bwd_dkv",
                        lambda *a, **kw: launches.append("dkv") or fa.flash_bwd_dkv_split_plain(*a))
    model = convert.load_variables(transformer.create_model(**cfg), {"params": params})
    assert model.cfg.head_dim == d == fa.head_width(d)
    loss, _ = transformer.make_loss_fn(model)(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    assert sorted(set(launches)) == ["dkv", "dq", "fwd"] and len(launches) == 6
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), atol=1e-5, rtol=0, err_msg=name)
