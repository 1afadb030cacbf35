"""Shared setup of ``test_torch_kv_tiering.py`` and
``test_torch_prefix_cache.py``: the JAX package's tiering and prefix-cache
tests' tiny fp32 Llama (2 layers, width 32, head dim 8, GQA 2:1), one set
of flax weights through the weight bridge, both packages' v2 engines at
those tests' settings, and a serving loop that audits the pool and the
tiers after every step."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.resilience import sdc

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
# the reference tests' engine: four 40-token sequences cannot all stay
# resident in 9 pages, so growth stalls force the spill-or-evict choice
BASE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, page_size=16,
            num_pages=9, decode_block_size=4, kv_reserve="on_demand")
PAGE = 16


def weights():
    cfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                param_dtype=jnp.float32, remat=False,
                                scan_layers=False, use_flash_attention=False)
    params = jax_llama.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    return dict(cfg=cfg, params=params, state=flax_to_state_dict(params))


def jax_engine(w, **kw):
    return JaxEngine(jax_llama.LlamaForCausalLM(w["cfg"]),
                     params=w["params"], rng=jax.random.PRNGKey(11),
                     **{**BASE, **kw})


def port_engine(w, **kw):
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(
            llama.LlamaConfig(**TINY, dtype=torch.float32))
    return RaggedInferenceEngineV2(model, params=w["state"], device="cpu",
                                   **{**BASE, **kw})


def prompts(sizes, seed=3):
    r = np.random.default_rng(seed)
    return [r.integers(1, 64, size=(s,), dtype=np.int32) for s in sizes]


def shared_prompts(n, sys_pages=2, suffix=6, seed=3, repeat_of=None):
    """``n`` prompts sharing a ``sys_pages``-page system prompt with
    distinct suffixes; ``repeat_of`` maps an index to an earlier one it
    repeats verbatim (a full match)."""
    r = np.random.default_rng(seed)
    system = r.integers(1, 64, size=(sys_pages * PAGE,), dtype=np.int32)
    out = []
    for i in range(n):
        if repeat_of and i in repeat_of:
            out.append(out[repeat_of[i]].copy())
        else:
            sfx = r.integers(1, 64, size=(suffix,), dtype=np.int32)
            out.append(np.concatenate([system, sfx]))
    return out


def serve(eng, ps, audit=True, **req_kw):
    """Submit ``ps``, step until drained; with ``audit`` (port engines)
    the pool's refcounts and the tiers' usage are audited after every
    step.  Returns {uid: tokens}."""
    req_kw.setdefault("max_new_tokens", 40)
    for p in ps:
        eng.put_request(p, **req_kw)
    outs = {}
    while eng.has_work():
        eng.step()
        outs.update(eng.get_outputs())
        if audit:
            eng.audit_kv_sharing()
            if eng.tiering is not None:
                eng.tiering.audit()
    outs.update(eng.get_outputs())
    return outs


def assert_same(a, b):
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=f"uid {uid}")


def check_restores(eng):
    """Wrap a port engine's ``_restore`` so that every restored page's
    bytes, read back from the pool, equal its spill-time digest.  Returns
    the list the wrapper appends each checked restore's page count to."""
    checked = []
    restore = eng._restore

    def checked_restore(req):
        info = req.spilled
        n, jn = info["n_pages"], len(info.get("shared_pages", ()))
        want = (eng.tiering.spill_digests(req.uid)
                if n and eng.tiering.holds(req.uid) else None)
        restore(req)
        if want is None or req.slot < 0:       # nothing spilled, or failed
            return
        pages = [int(p) for p in eng.page_table[req.slot, jn:jn + n]]
        got = eng._gather_pages(pages).reshape(n, -1)
        assert [sdc.digest(b, eng.tiering.algo) for b in got] == want, (
            f"uid {req.uid}: restored pages differ from the spilled ones")
        checked.append(n)

    eng._restore = checked_restore
    return checked
