"""`PagedEngine` and the serving steps in both packages: a tiny llama (2
layers, 8 query heads over 4 KV heads), the port on the CPU with its plain
versions, JAX on the CPU (`NST_FLASH=interpret`: at page size 128 the paged
Pallas kernels with the fused append; at 16 the JAX entry leaves attention
to XLA and appends first).

* Against JAX `PagedEngine`, at page sizes 16 and 128, on a pool smaller
  than max_batch x max_len: a ragged prefill, greedy decode with growth
  across a page boundary, release of a slot and a prefill into the freed,
  fragmented pages through `prepare_prefill` / `run_prefill` while the
  other slot decodes.  Page tables equal, logits within LOGIT_TOL (as
  `test_torch_model.py`: bf16 activations summed in another order and, at
  page size 16, JAX's float32 attention), greedy ids identical with the
  top-2 margin above LOGIT_TOL at every step.
* The port's `PagedEngine` against the port's contiguous `Engine`: logits
  bit for bit (the plain paged versions read the gathered layer with the
  contiguous versions' arithmetic).
* Fused against plain `kv_append` on the port's `PagedEngine`: greedy ids
  equal, logits within the self-column quantization step, pools equal.
* `run_decode_chunk` and `run_decode_window` with greedy params against
  JAX's: tokens, emitted counts, active flags and budgets equal, with a
  budget stop and an EOS stop inside the window.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_speed_tpu.models.arch import ArchConfig as JArchConfig
from neural_speed_tpu.ops import sampling as jsmp
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu.runtime.engine import PagedEngine as JPagedEngine
from neural_speed_tpu.utils.synthetic import synth_params as jax_synth_params
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models.arch import ArchConfig
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import sampling as tsmp
from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

from tests.torch_port_util import tree_to_numpy

torch.set_num_threads(1)

LOGIT_TOL = 0.2
CFG = dict(name="llama", vocab_size=128, hidden_size=256, n_layers=2,
           n_heads=8, n_kv_heads=4, intermediate_size=448,
           max_position_embeddings=256)
MAX_LEN = 256
PROMPTS = [list(np.random.default_rng(0).integers(1, 128, 124)),
           [7, 7, 100, 3, 9, 4, 31, 8, 2]]
# a params seed whose greedy streams keep every checked top-2 margin above
# 0.9 in the port (searched on the CPU): equal ids are then a real check
SEED = 183


def _params():
    jcfg = JArchConfig(**CFG, kv_append="fused")
    jp = jax_synth_params(
        jcfg, JSpec(JQType.INT, 4, 64, True, scale_dtype="bfloat16"),
        seed=SEED)
    return jcfg, jp


def _jax_engine(ps, n_pages, monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    jcfg, jp = _params()
    return JPagedEngine(jp, jcfg, max_batch=2, max_len=MAX_LEN,
                        kv_quantized=True, page_size=ps, n_pages=n_pages)


def _port(cls, mode="fused", **kw):
    _, jp = _params()
    return cls(params_from_numpy(tree_to_numpy(jp), device="cpu"),
               ArchConfig(**CFG, kv_append=mode), max_batch=2,
               max_len=MAX_LEN, kv_quantized=True, device="cpu", **kw)


def _check_step(pl, jl, active, step):
    np.testing.assert_allclose(pl[active], jl[active], rtol=0,
                               atol=LOGIT_TOL, err_msg=f"step {step}")
    top2 = np.sort(jl[active], axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > LOGIT_TOL), step
    np.testing.assert_array_equal(pl.argmax(-1)[active],
                                  jl.argmax(-1)[active])
    return jl.argmax(-1).astype(np.int32)


@pytest.mark.parametrize("ps,n_pages", [(16, 20), (128, 3)])
def test_paged_engine_matches_jax(ps, n_pages, monkeypatch):
    assert n_pages < 2 * MAX_LEN // ps          # the pool is smaller
    je = _jax_engine(ps, n_pages, monkeypatch)
    pe = _port(PagedEngine, page_size=ps, n_pages=n_pages)
    both = np.array([True, True])

    jl = np.asarray(je.prefill(PROMPTS), np.float32)
    pl = pe.prefill(PROMPTS).numpy()
    ids = _check_step(pl, jl, both, "prefill")
    # slot 0 grows from 124 across the 128 boundary
    for step in range(6):
        jl = np.asarray(je.decode(jnp.asarray(ids), jnp.asarray(both)),
                        np.float32)
        pl = pe.decode(torch.from_numpy(ids), torch.from_numpy(both)).numpy()
        ids = _check_step(pl, jl, both, step)
        np.testing.assert_array_equal(pe._tables, je._tables)

    # release slot 0 and prefill a new prompt into the freed pages while
    # slot 1 stays live (a spectator of the prefill)
    for e in (je, pe):
        e.release_slot(0)
        assert e._alloc.available == len(je._alloc.free)
    new = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6]
    t = 32
    ids_np = np.zeros((2, t), np.int32)
    ids_np[0, :len(new)] = new
    lens = np.array([len(new), 0], np.int32)
    starts = np.zeros((2,), np.int32)
    for e in (je, pe):
        e.prepare_prefill([0], [len(new)], starts=starts)
    np.testing.assert_array_equal(pe._tables, je._tables)
    jl = np.asarray(je.run_prefill(jnp.asarray(ids_np), jnp.asarray(lens),
                                   jnp.asarray(starts)), np.float32)
    pl = pe.run_prefill(torch.from_numpy(ids_np), torch.from_numpy(lens),
                        torch.from_numpy(starts)).numpy()
    first = _check_step(pl, jl, np.array([True, False]), "re-prefill")
    ids = np.array([first[0], ids[1]], np.int32)
    for step in range(3):
        jl = np.asarray(je.decode(jnp.asarray(ids), jnp.asarray(both)),
                        np.float32)
        pl = pe.decode(torch.from_numpy(ids), torch.from_numpy(both)).numpy()
        ids = _check_step(pl, jl, both, f"after re-prefill {step}")
    np.testing.assert_array_equal(pe.cache.lengths.numpy(),
                                  np.asarray(je.cache.lengths))
    for e in (je, pe):
        e.release_slot(0)
        e.release_slot(1)
    assert pe._alloc.available == pe.n_pages - 1 and not pe._alloc.refs


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_paged_engine_equals_contiguous_engine(mode):
    ce = _port(Engine, mode)
    pe = _port(PagedEngine, mode, page_size=16, n_pages=24)
    both = torch.tensor([True, True])
    before = dict(_build.plain_dispatches)
    assert torch.equal(pe.prefill(PROMPTS), ce.prefill(PROMPTS))
    assert (_build.plain_dispatches["flash_prefill_paged"]
            == before.get("flash_prefill_paged", 0) + CFG["n_layers"])
    toks = torch.tensor([11, 80], dtype=torch.int32)
    for step in range(10):
        active = both if step < 6 else torch.tensor([True, False])
        pl, cl = pe.decode(toks, active), ce.decode(toks, active)
        assert torch.equal(pl, cl), step
        toks = cl.argmax(-1).to(torch.int32)
    assert torch.equal(pe.cache.lengths, ce.cache.lengths)
    n = "flash_decode_paged" if mode == "fused" else "flash_prefill_paged"
    assert _build.plain_dispatches[n] > before.get(n, 0)


def test_paged_fused_append_matches_plain_append():
    outs = {}
    for mode in ("plain", "fused"):
        pe = _port(PagedEngine, mode, page_size=16, n_pages=24)
        lg = [pe.prefill(PROMPTS)]
        toks = lg[0].argmax(-1).to(torch.int32)
        for _ in range(6):
            lg.append(pe.decode(toks, torch.tensor([True, True])))
            toks = lg[-1].argmax(-1).to(torch.int32)
        outs[mode] = (lg, pe.cache)
    (pl, pc), (fl, fc) = outs["plain"], outs["fused"]
    # the fused step attends to the unquantized newest k/v, the plain one
    # to its stored int8 copy: within 6e-2 (the JAX package's own check)
    for a, b in zip(pl, fl):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=6e-2, rtol=6e-2)
        np.testing.assert_array_equal(a.argmax(-1).numpy(),
                                      b.argmax(-1).numpy())
    assert any(not torch.equal(a, b) for a, b in zip(pl, fl))
    # layer 0 reads the same tokens in both (deeper layers see the
    # attention outputs, which differ): its pool is equal bit for bit on
    # every page but the trash page
    n = pc.k_pages.shape[2] - 1
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        assert torch.equal(getattr(pc, name)[0, :, :n],
                           getattr(fc, name)[0, :, :n]), name


# greedy, with a repetition penalty strong enough that the random model
# does not repeat one token
GREEDY = dict(do_sample=False, repetition_penalty=2.0)


def _serve(eng, jax_side, eos_id, w=6, chunk=3):
    """The scheduler's calls for two requests: prefill, one chunk, then one
    window with budgets [5, 2].  Returns everything the steps produced."""
    conv = ((lambda a: jnp.asarray(a)) if jax_side
            else (lambda a: torch.from_numpy(np.asarray(a))))
    host = (lambda a: np.asarray(a))
    if jax_side:
        st = jsmp.init_state(jax.random.PRNGKey(0), 2, CFG["vocab_size"],
                             window=64)
        sp, smp = jsmp.SamplingParams(**GREEDY), jsmp
    else:
        st = tsmp.init_state(0, 2, CFG["vocab_size"], window=64,
                             device="cpu")
        sp, smp = tsmp.SamplingParams(**GREEDY), tsmp
    t = 128
    ids = np.zeros((2, t), np.int32)
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
        st = smp.observe_prompt_slot(st, i, p)
    starts = np.zeros((2,), np.int32)
    eng.prepare_prefill([0, 1], lens, starts=starts)
    first = host(eng.run_prefill(conv(ids), conv(lens), conv(starts))
                 ).argmax(-1).astype(np.int32)
    active = np.array([True, True])
    eng.prepare_decode(active, chunk)
    toks, st = eng.run_decode_chunk(st, conv(first), conv(active), chunk, sp)
    toks = host(toks)
    slot_len = lens + chunk
    eng.commit_lens(slot_len)
    budget = np.array([5, 2], np.int32)
    eng.prepare_decode(active, w)
    buf, em, last, act, bud, st = eng.run_decode_window(
        st, conv(toks[:, -1]), conv(active), conv(budget), w, 8, sp, eos_id)
    em = host(em)
    eng.commit_lens(slot_len + em)
    return dict(chunk=toks, buf=host(buf), em=em, last=host(last),
                act=host(act), bud=host(bud),
                lengths=host(eng.cache.lengths))


def test_decode_chunk_and_window_match_jax(monkeypatch):
    # find an EOS that stops slot 0 inside the window: the first of its
    # tokens that neither slot emitted before
    dry = _serve(_port(PagedEngine, page_size=16, n_pages=24), False, None)
    assert list(dry["em"]) == [5, 2]             # budget stops
    buf = dry["buf"]
    j = next(j for j in range(1, 4) if buf[0, j] not in buf[0, :j]
             and buf[0, j] not in buf[1, :2])
    for eos_id, em in ((None, [5, 2]), (int(buf[0, j]), [j + 1, 2])):
        pe = _port(PagedEngine, page_size=16, n_pages=24)
        je = _jax_engine(16, 24, monkeypatch)
        got = _serve(pe, False, eos_id)
        want = _serve(je, True, eos_id)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert list(got["em"]) == em
        assert not got["act"].any()
        # columns past a slot's stop repeat its last token, as JAX's do
        stop = int(got["em"][0])
        np.testing.assert_array_equal(got["buf"][1, 2:stop], got["buf"][1, 1])
        assert not got["buf"][:, stop:].any()
