"""The port's training path against the JAX package's on the same state.

The reference's ``init_params`` / ``init_state`` draws the weights; the
bridge carries them (and the optimizer's state) over as numpy arrays, and
both packages take the same numpy-made batches (their own trainers draw
data from different generators).  Everything runs in f32 on the CPU, the
port's kernels as their plain versions with the gradients of
`repro_torch.kernels.autograd`.  Tolerances:

- the loss, aux loss and gradient norm of every step within 1e-5
  relative (sums in another order), the perplexity within 1e-4 (its
  relative error is the loss's absolute one);
- each gradient leaf within 1e-4 of its largest |value|;
- after three optimizer steps, each leaf of the parameters and of the
  optimizer's state within 1e-4 of its Frobenius norm: AdamW's first
  steps move an element by about ``lr · sign(g)``, so an element whose
  gradient lies within rounding of 0 may move differently by up to
  ``2 · lr``, which an elementwise bound would have to admit everywhere.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ModelRuntime as JaxRuntime
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import init_state as jax_init_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.models import (ModelRuntime, decode_step, forward_train,
                                prefill)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.bridge import params_from_numpy, tree_to_numpy
from repro_torch.training import (OptimizerConfig, TrainConfig, Trainer,
                                  make_train_step)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PPL_TOL = dict(rtol=1e-4)
GRAD_TOL = 1e-4
STATE_TOL = 1e-4
STEPS = 3
#: one architecture of each family for Adafactor and grad accumulation
FAMILIES = ("internlm2-1.8b", "olmoe-1b-7b", "falcon-mamba-7b",
            "zamba2-1.2b")


def _batch(cfg, seed, b, s):
    """Tokens (or codes) and the labels one step on, and a VLM's patch
    embeddings in the first 4 slots, from numpy."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, s) if cfg.num_codebooks else (b, s)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}
    if cfg.frontend == "vision":
        out["embeds_override"] = (rng.standard_normal(
            (b, 4, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return params_from_numpy(tree, device="cpu")


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float32)


def _assert_tree_close(got, want, rel):
    got = dict(_leaves_with_paths(tree_to_numpy(got)))
    want = dict(_leaves_with_paths(jax.tree.map(np.asarray, want)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        d = float(np.linalg.norm(got[path] - w))
        assert d <= rel * float(np.linalg.norm(w)) + 1e-7, (path, d)


def _assert_grads_close(got, want):
    want = dict(_leaves_with_paths(jax.tree.map(np.asarray, want)))
    got = dict(_leaves_with_paths(tree_to_numpy(got)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        top = float(np.abs(w).max())
        assert float(np.abs(got[path] - w).max()) <= GRAD_TOL * top + 1e-9, \
            path


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jax_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    return jcfg, get_smoke_config(arch), jax.tree.map(np.asarray, jparams)


def _with_grad(tree, leaves):
    if isinstance(tree, dict):
        return {k: _with_grad(v, leaves) for k, v in tree.items()}
    t = tree.detach().requires_grad_(True)
    leaves.append(t)
    return t


def _port_grads(cfg, params, batch, rt=ModelRuntime()):
    leaves = []
    tparams = _with_grad(_torch(params), leaves)
    loss, metrics = forward_train(cfg, tparams, _torch(batch), rt=rt)
    loss.backward()
    loss = loss.detach()

    def grads(tree):
        if isinstance(tree, dict):
            return {k: grads(v) for k, v in tree.items()}
        return tree.grad
    return loss, metrics, grads(tparams)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_matches_reference(arch):
    """The loss, its metrics (the MoE's aux loss carried out of the layer
    loop) and every parameter's gradient."""
    jcfg, cfg, params = _weights(arch)
    batch = _batch(cfg, 1, 2, 16)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jax_forward_train(jcfg, p, _jax(batch)), has_aux=True)(
            _jax(params))
    loss, metrics, grads = _port_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    for k in ("loss", "aux_loss", "perplexity"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmet[k]),
                                   **(PPL_TOL if k == "perplexity"
                                      else LOSS_TOL))
    if cfg.family == "moe":
        assert float(metrics["aux_loss"].detach()) > 0
    _assert_grads_close(grads, jgrads)


def _train_cases():
    cases = [(arch, "adamw", 1) for arch in ARCH_IDS]
    cases += [(arch, "adafactor", accum) for arch in FAMILIES
              for accum in (1, 2)]
    cases.append(("internlm2-1.8b", "adamw", 2))
    return cases


@pytest.mark.parametrize("arch,opt,accum", _train_cases(),
                         ids=lambda v: str(v))
def test_train_steps_match_reference(arch, opt, accum):
    """Three ``make_train_step`` steps from the reference's bridged
    ``init_state``: each step's metrics, then the parameters and the
    optimizer's state."""
    jcfg, cfg, _ = _weights(arch)
    kw = dict(learning_rate=1e-3, name=opt)
    jtc = JaxTrainConfig(optimizer=JaxOptimizerConfig(**kw),
                         grad_accum=accum, compute_dtype="float32")
    tc = TrainConfig(optimizer=OptimizerConfig(**kw), grad_accum=accum,
                     compute_dtype="float32")
    jstate = jax_init_state(jcfg, jtc, 0)
    state = _torch(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jax_make_train_step(jcfg, jtc))
    step = make_train_step(cfg, tc)
    for i in range(STEPS):
        batch = _batch(cfg, 10 + i, 2 * accum, 16)
        jstate, jmet = jstep(jstate, _jax(batch))
        state, met = step(state, _torch(batch))
        assert met.keys() == jmet.keys()
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       **(PPL_TOL if k == "perplexity"
                                          else LOSS_TOL))
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    assert state["step"].dtype == torch.int32
    _assert_tree_close(state["params"], jstate["params"], STATE_TOL)
    _assert_tree_close(state["opt"], jstate["opt"], STATE_TOL)


def _flat_grads(grads):
    return [t for _, t in _leaves_with_paths(tree_to_numpy(grads))]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none(arch, remat):
    """Recomputing a layer in the backward (all of it, or all but the
    matrix products without batch dims) runs the same ops on the same
    inputs: the loss and every gradient bit for bit."""
    _, cfg, params = _weights(arch)
    batch = _batch(cfg, 2, 2, 16)
    loss, _, grads = _port_grads(cfg, params, batch)
    rloss, _, rgrads = _port_grads(cfg, params, batch,
                                   ModelRuntime(remat=remat))
    assert float(loss) == float(rloss)
    for a, b in zip(_flat_grads(grads), _flat_grads(rgrads)):
        np.testing.assert_array_equal(a, b)


def _qkv(seed, b=2, s=20, h=4, kv=2, dh=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))]


@pytest.mark.parametrize("causal", [True, False])
def test_attention_chunked_train_matches_reference(causal):
    """Blocks of 8 over 20 queries (the last one short), GQA 2; the
    output and its gradients against the reference's, and the gradient
    equal to attention_naive's whole pass."""
    jcfg, cfg, _ = _weights("internlm2-1.8b")
    q, k, v = _qkv(3)
    up = np.random.default_rng(4).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        out = JL.attention_chunked_train(jcfg, q, k, v, causal=causal,
                                         q_block=8)
        return jnp.sum(out * up), out
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = L.attention_chunked_train(cfg, tq, tk, tv, causal=causal,
                                    q_block=8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad((out * torch.from_numpy(up)).sum(),
                              (tq, tk, tv))
    for a, w in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    naive = L.attention_naive(cfg, tq, tk, tv, causal=causal)
    want = torch.autograd.grad((naive * torch.from_numpy(up)).sum(),
                               (tq, tk, tv))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["chunked", "auto"])
def test_chunked_routes_train_through_attention_chunked_train(impl):
    """A departure: the reference's ``chunked`` (and ``auto`` at or above
    ``chunked_threshold``) is its online-softmax ``attention_chunked``;
    the port has no backward for a flash kernel, so it trains every
    chunked route through ``attention_chunked_train``.  The two compute
    the same function: the loss and gradients agree within f32
    rounding."""
    jcfg, cfg, params = _weights("internlm2-1.8b")
    batch = _batch(cfg, 5, 2, 24)
    kw = dict(attn_impl=impl, q_block=8, kv_block=8, chunked_threshold=16)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_forward_train(jcfg, p, _jax(batch),
                                    rt=JaxRuntime(**kw)), has_aux=True)(
            _jax(params))
    loss, _, grads = _port_grads(cfg, params, batch, ModelRuntime(**kw))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    _assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("arch,ssd", [("falcon-mamba-7b", False),
                                      ("zamba2-1.2b", False),
                                      ("zamba2-1.2b", True)])
def test_ssm_prompt_pass_is_bit_equal_with_grad(arch, ssd):
    """The scan's rounds write a second buffer in place where no input
    needs a gradient and build fresh tensors where one does: the same ops
    in the same order, so the block's output and state are equal bit for
    bit (5 chunks of 4, the last one short)."""
    _, cfg, params = _weights(arch)
    cfg = dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=4, ssd_matmul=ssd))
    blk = {k: v[0] for k, v in _torch(params)["layers"]["mamba"].items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32))
    plain = S.apply_mamba_with_state(cfg, blk, x, None)
    grad = S.apply_mamba_with_state(cfg, blk, x.clone().requires_grad_(),
                                    None)
    assert grad[0].grad_fn is not None
    for a, b in zip(plain, grad):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_seq_shard_off_a_mesh_matches_reference():
    """``seq_shard`` constrains the residual stream over a mesh
    (`tests/test_torch_distributed.py` holds it there); off one it
    changes nothing, in the port as in the reference: the loss with it
    equals the reference's with it, and the port's without it."""
    jcfg, cfg, params = _weights("internlm2-1.8b")
    batch = _batch(cfg, 8, 2, 16)
    rt = JaxRuntime(seq_shard=True)
    want, _ = jax_forward_train(jcfg, _jax(params), _jax(batch), rt=rt)
    got, _ = forward_train(cfg, _torch(params), _torch(batch),
                           rt=ModelRuntime(seq_shard=True))
    plain, _ = forward_train(cfg, _torch(params), _torch(batch))
    assert abs(float(got) - float(want)) < 1e-4
    assert float(got) == float(plain)


def test_unroll_decode_has_no_effect():
    """``unroll_decode`` is accepted and changes nothing: the port's
    decode is always unrolled and in place, so its logits match the
    reference's unrolled decode, and a train step reads no decode
    flag."""
    jcfg, cfg, params = _weights("internlm2-1.8b")
    toks = _batch(cfg, 7, 2, 8)["tokens"]
    rt = JaxRuntime(unroll_decode=True)
    _, jcache = jax_prefill(jcfg, _jax(params), jnp.asarray(toks),
                            max_len=12, cache_dtype=jnp.float32, rt=rt)
    want, _ = jax_decode_step(jcfg, _jax(params), jcache,
                              jnp.asarray(toks[:, -1]), rt=rt)
    _, cache = prefill(cfg, _torch(params), torch.from_numpy(toks),
                       max_len=12)
    logits, _ = decode_step(cfg, _torch(params), cache,
                            torch.from_numpy(toks[:, -1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    batch = _batch(cfg, 8, 2, 8)
    a = _port_grads(cfg, params, batch)[0]
    b = _port_grads(cfg, params, batch, ModelRuntime(unroll_decode=True))[0]
    assert float(a) == float(b)


def test_token_stream_is_restart_reproducible():
    """A step's batch depends on (seed, step) alone; the trainer draws
    from the stream of ``seed + 7``."""
    cfg = get_smoke_config("internlm2-1.8b")
    s = TokenStream(cfg, 2, 8, seed=3, device="cpu")
    b0, b1 = s.batch(0), s.batch(1)
    assert torch.equal(b0["tokens"], TokenStream(cfg, 2, 8, 3, "cpu").batch(
        0)["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert torch.equal(b0["labels"], torch.roll(b0["tokens"], -1, -1))
    first = next(iter(s))
    assert torch.equal(first["tokens"], b0["tokens"])
    tc = TrainConfig(compute_dtype="float32")
    trainer = Trainer(cfg, tc, batch_size=2, seq_len=8, seed=-4,
                      device="cpu")
    assert torch.equal(trainer.data_for_step(1)["tokens"], b1["tokens"])
