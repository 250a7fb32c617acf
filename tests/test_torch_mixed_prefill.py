"""Mixed prefill+decode scheduling (`ContinuousBatchingScheduler(
mixed_prefill=True)`: `_admit_mixed` and the joint steps) in the port
against the JAX scheduler, on the CPU.

`tests/test_torch_scheduler.py`'s tiny llama and `tests/
test_torch_speculative.py`'s requests (5 prompts of 30 to 77 tokens,
searched for clear greedy margins, over 2 slots, greedy with the
repetition penalty 1.1, the scheduler's default), JAX under
`NST_FLASH=interpret`.  Prompts are fed
`mixed_chunk` tokens per joint step beside the decoding slots' rows, so
every prompt longer than the chunk is admitted over several steps while
another request decodes.  Held: per request the same ids and the same
finish order as JAX's, over `Engine` and `PagedEngine` (page sizes 128
and 16, where the chunk and the buckets clamp to the page), bf16 and int8
caches; every pick's top-2 margin above LOGIT_TOL (`HostMargins`,
`_Margins`); the page pool free at the end.
"""

import pytest
import torch

from neural_speed_tpu_torch.runtime.scheduler import (
    ContinuousBatchingScheduler, SeqStatus)

from tests.test_torch_scheduler import JScheduler, _Margins, engines, serve
from tests.test_torch_speculative import SPEC_PROMPTS, HostMargins

torch.set_num_threads(1)
MIXED_CHUNK = 16
PROMPTS = SPEC_PROMPTS[:5]
# request 1 finishes while request 0 decodes, so request 2 (77 tokens) is
# admitted in chunks beside it, and so on down the queue
BUDGETS = [24, 6, 16, 12, 20]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


@pytest.mark.parametrize("kind", ["contiguous", 128, 16],
                         ids=["engine", "paged128", "paged16"])
@pytest.mark.parametrize("kv_quantized", [False, True], ids=["bf16", "int8"])
def test_mixed_prefill_matches_jax(kind, kv_quantized, monkeypatch):
    assert max(map(len, PROMPTS)) > MIXED_CHUNK
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    je, pe = engines(kind, kv_quantized)
    want = serve(JScheduler(je, mixed_prefill=True, mixed_chunk=MIXED_CHUNK),
                 PROMPTS, BUDGETS)
    sched = ContinuousBatchingScheduler(pe, mixed_prefill=True,
                                        mixed_chunk=MIXED_CHUNK)
    got = serve(sched, PROMPTS, BUDGETS)
    assert got == want
    assert [len(g) for _, g in sorted(got)] == BUDGETS
    assert sched.mixed_chunk == (MIXED_CHUNK if kind == "contiguous"
                                 else min(MIXED_CHUNK, kind))
    if kind != "contiguous":
        assert pe._alloc.available == pe.n_pages - 1
    margins.check()
    dev_margins.check()


def test_mixed_admission_feeds_chunks_beside_decode(monkeypatch):
    """A long prompt arriving while another request decodes is fed in
    chunks of `mixed_chunk` over several joint steps, the decoding slot
    advancing one token at each of them; JAX's scheduler takes the same
    steps and delivers the same ids."""
    margins = HostMargins(monkeypatch)
    runs = []
    for side, eng in zip(("jax", "port"), engines("contiguous", True)):
        cls = JScheduler if side == "jax" else ContinuousBatchingScheduler
        sched = cls(eng, mixed_prefill=True, mixed_chunk=8)
        out, steps = {}, []
        rids = [sched.add_request(PROMPTS[1], 12)]
        sched.step()                                   # prefill request 0
        rids.append(sched.add_request(PROMPTS[0], 6))  # 77 tokens
        while sched.has_work:
            sched.step()
            steps.append(tuple(sorted(
                (s.request_id, s.status, len(s.generated),
                 getattr(s, "fed", 0)) for s in sched.running.values())))
            for s in sched.pop_finished():
                out[s.request_id] = s.generated
        runs.append(([out[r] for r in rids], steps))
    assert runs[0] == runs[1]
    fed = [f for step in runs[1][1] for rid, st, _, f in step
           if rid == 1 and st == SeqStatus.PREFILL]
    assert fed[:3] == [8, 16, 24] and len(fed) == 77 // 8
    margins.check()


def test_mixed_and_speculative_together(monkeypatch):
    """mixed_prefill with speculation: the joint steps carry prompt chunks
    and draft rows together; JAX's ids on the page pool at size 16 (where
    spec_k and the chunk clamp to the page)."""
    margins = HostMargins(monkeypatch)
    dev_margins = _Margins(monkeypatch)
    je, pe = engines(16, True)
    kw = dict(mixed_prefill=True, mixed_chunk=MIXED_CHUNK, speculative=True,
              spec_k=5)
    want = serve(JScheduler(je, **kw), PROMPTS, BUDGETS)
    assert serve(ContinuousBatchingScheduler(pe, **kw), PROMPTS,
                 BUDGETS) == want
    assert pe._alloc.available == pe.n_pages - 1
    margins.check()
    dev_margins.check()
