"""An MoE draft model on the port's v2 engine (A12c) against the JAX v2
engine's, on the CPU in fp32.

A Mixtral target with a Mixtral draft and a Qwen2-MoE target with a
Qwen2-MoE draft (each draft its family's tiny preset at another seed),
``speculation="draft"`` at k 4, on the JAX breadth tests' schedule:

- greedy tokens equal the JAX engine's with the same draft (exact), and
  with ``drop_tokens`` off the port's with speculation off too.  With
  drops on they need not: the target's verify tick routes k+1 rows a
  slot, so its capacity drops depend on the proposals, and the JAX
  engine's own speculative tokens differ from its tokens with
  speculation off on this schedule;
- the draft's catch-up chunks equal the JAX engine's count, each padded
  to ``prefill_chunk`` rows as the JAX engine pads them, with the pad
  rows' K/V on the trash page (every live page of the draft pool is
  written by real rows only);
- with ``drop_tokens`` off (the Qwen2-MoE case: no capacity couples a
  chunk's rows), the proposed and accepted draft tokens equal the JAX
  engine's.

The counts differ by design where a slot's length less 2 is a multiple
of the chunk: the port's catch-up stops one position lower, since its
first draft step runs two rows a slot (ROADMAP §C, known divergences).
With ``drop_tokens`` on, that first step's two rows a slot can drop
other copies than the JAX draft's one row, so acceptance may differ
there; greedy tokens may not.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from test_torch_moe import V2, _init, _jax_model, _port_model, _prompts
import torch_cpu  # noqa: F401  (one torch thread a process)

SPEC = dict(speculation={"mode": "draft", "k": 4}, pipeline=False)
PROMPTS = _prompts([5, 11, 3], seed=22)
NEW = 12
# (family, config fields): drops on at the family's capacity, and off
CASES = {"mixtral": ("mixtral", {}),
         "qwen2_moe_no_drops": ("qwen2_moe", {"drop_tokens": False})}


def _count_jax_chunks(eng):
    """Wrap the JAX engine's draft prefill to count its catch-up
    chunks."""
    calls = [0]
    make = eng._draft_prefill_fn

    def counted():
        fn = make()

        def run(*a):
            calls[0] += 1
            return fn(*a)
        return run
    eng._draft_prefill_fn = counted
    return calls


@pytest.fixture(scope="module")
def served():
    out = {}
    for case, (family, cfg_kw) in CASES.items():
        jmodel, jdraft = (_jax_model(family, **cfg_kw) for _ in range(2))
        params, dparams = _init(jmodel, seed=22), _init(jdraft, seed=23)
        eng = JaxEngine(jmodel, params=params, draft_model=jdraft,
                        draft_params=dparams, **{**V2, **SPEC})
        calls = _count_jax_chunks(eng)
        toks = eng.generate_all(PROMPTS, max_new_tokens=NEW)
        spec = eng.serving_stages()["speculation"]
        eng.close()
        out[case] = dict(state=flax_to_state_dict(params),
                         dstate=flax_to_state_dict(dparams), toks=toks,
                         chunks=calls[0], proposed=spec["proposed"],
                         accepted=spec["accepted"])
    return out


def _port(case, st, spec=True):
    family, cfg_kw = CASES[case]
    kw = dict(SPEC) if spec else dict(pipeline=False)
    if spec:
        kw.update(draft_model=_port_model(family, **cfg_kw),
                  draft_params=st["dstate"])
    return RaggedInferenceEngineV2(_port_model(family, **cfg_kw),
                                   params=st["state"], device="cpu",
                                   **{**V2, **kw})


@pytest.mark.parametrize("case", list(CASES))
def test_moe_draft_matches_jax(served, case):
    st = served[case]
    eng = _port(case, st)
    assert eng._draft_moe
    rows = []
    inner = eng._draft_module.forward

    def forward(ids, *a, **kw):
        rows.append(ids.shape[1])
        return inner(ids, *a, **kw)
    eng._draft_module.forward = forward
    got = eng.generate_all(PROMPTS, max_new_tokens=NEW)
    spec = eng.serving_stages()["speculation"]
    eng.audit_kv_sharing()
    off = _port(case, st, spec=False).generate_all(PROMPTS,
                                                   max_new_tokens=NEW)
    drops = CASES[case][1].get("drop_tokens", True)
    assert sorted(got) == sorted(st["toks"]) == sorted(off)
    for uid in got:
        np.testing.assert_array_equal(got[uid], st["toks"][uid])
        if not drops:
            np.testing.assert_array_equal(got[uid], off[uid])
    assert spec["spec_dispatches"] > 0
    assert eng.draft_catchup_chunks == st["chunks"] > 0
    # every catch-up call is one padded chunk of prefill_chunk rows; the
    # draft steps run 2 and 1 rows a slot
    S = V2["max_seqs"]
    assert rows.count(V2["prefill_chunk"]) == eng.draft_catchup_chunks
    assert set(rows) <= {V2["prefill_chunk"], 2 * S, S}
    if not drops:
        assert (spec["proposed"], spec["accepted"]) == (
            st["proposed"], st["accepted"])


def test_pad_rows_write_the_trash_page(served):
    """A padded catch-up chunk writes the draft's K/V of its live rows
    and nothing else: after the catch-up of one request, every draft
    pool row outside the trash page is zero except the positions below
    the draft's coverage in the request's own pages."""
    st = served["mixtral"]
    eng = _port("mixtral", st)
    eng.put_request(PROMPTS[1], max_new_tokens=NEW)
    eng.step()                                    # admit and prefill
    r = next(s for s in eng.slots if s is not None)
    while r.prefill_done < r.ctx_len:
        eng.step()
    eng._draft_catchup([r])          # what the next block runs first
    assert eng.draft_catchup_chunks == 2
    covered = int(eng._draft_len[r.slot])
    assert covered > V2["prefill_chunk"]          # a padded last chunk
    page = eng.page_size
    want = torch.zeros(eng.num_pages, page, dtype=torch.bool)
    for pos in range(covered):
        want[eng.page_table[r.slot, pos // page], pos % page] = True
    for pool in eng._draft_cache:
        written = pool.pages.flatten(2).ne(0).any(dim=-1)
        assert torch.equal(written[1:], want[1:])
