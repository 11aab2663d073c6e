"""PyTorch port vs JAX package: tenants on the continuous paged fleet.

A request's `tenant` rides into the fleet in both packages: it weighs the
tenant's share of each SLO class's prefill grant (engine_cfg.
tenant_weights), caps its share of the bounded queue (engine_cfg.
tenant_max_queue_share: the over-quota tenant sheds with a 429
"overloaded" envelope that names it, and dli_tenant_shed_total{tenant}
counts it), and is echoed in the envelope. Both fleets run on the CPU
with the same weights (test-llama-tiny, fp32, no EOS): the shed envelopes,
the metric and the greedy tokens under two weighted tenants must be the
JAX fleet's."""

import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine import continuous as JC  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.config import EngineConfig  # noqa: E402
from distributed_llm_inference_tpu_torch.engine import continuous as TC  # noqa: E402
from distributed_llm_inference_tpu_torch.models.bridge import params_from_numpy  # noqa: E402
from distributed_llm_inference_tpu_torch.models.registry import get_model_config  # noqa: E402
from distributed_llm_inference_tpu_torch.runtime import create_engine  # noqa: E402

MODEL = "test-llama-tiny"
OVERRIDES = dict(dtype="float32", eos_token_id=-1, max_seq_len=512)
# chunked prefill on a 64-token step budget, so that long prompts of two
# tenants share the prefill grant over several mixed launches
ENGINE = dict(chunked_prefill=True, prefix_cache_entries=0, step_token_budget=64,
              prefill_buckets=(64, 128, 256), tenant_max_queue_share=0.5,
              tenant_weights=(("acme", 3.0), ("globex", 1.0)))
FLEET = dict(n_slots=4, chunk_steps=8, slot_max_seq=512, kv_pool_blocks=120,
             kv_block_size=16, max_queue=8)
KW = dict(max_tokens=4, greedy=True, chat=False)


@pytest.fixture(scope="module")
def fleets():
    from test_torch_continuous import IdTokenizer

    params = JM.init_params(jax_cfg(MODEL, **OVERRIDES), jax.random.PRNGKey(0))
    tcfg = get_model_config(MODEL, **OVERRIDES)
    tok = IdTokenizer()
    jeng = JaxEngine(jax_cfg(MODEL, **OVERRIDES), params=params,
                     engine_cfg=JaxEngineConfig(**ENGINE), tokenizer=tok)
    teng = create_engine(tcfg, params=params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), "cpu"),
        engine_cfg=EngineConfig(**ENGINE), tokenizer=tok, device="cpu")
    pair = {"jax": (JC, JC.ContinuousEngine(jeng, **FLEET)),
            "port": (TC, TC.ContinuousEngine(teng, **FLEET))}
    yield pair
    for _, fleet in pair.values():
        fleet.close()


def _counter(fleet, name, **labels):
    """A series' value from the fleet registry's Prometheus exposition."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    for line in fleet.engine.metrics.render().splitlines():
        m = re.fullmatch(rf"{name}\{{(.*)\}} (\S+)", line)
        if m and ",".join(sorted(m.group(1).split(","))) == want:
            return float(m.group(2))
    return 0.0


def test_engine_config_validates_the_tenant_knobs_as_jax_does():
    for kw in (dict(tenant_max_queue_share=0.0), dict(tenant_max_queue_share=1.5),
               dict(tenant_weights=(("", 1.0),)), dict(tenant_weights=(("a", 0),))):
        with pytest.raises(ValueError):
            JaxEngineConfig(**kw)
        with pytest.raises(ValueError):
            EngineConfig(**kw)
    port, jax_default = EngineConfig(), JaxEngineConfig()
    assert port.tenant_weights == jax_default.tenant_weights == ()
    assert port.tenant_max_queue_share == jax_default.tenant_max_queue_share == 0.5


def test_tenant_queue_quota_sheds_like_jax(fleets):
    """JAX tests/test_adapters.py::test_tenant_queue_quota_sheds through
    both fleets: with 4 requests of tenant "flood" queued (cap max(4,
    int(8 * 0.5)) = 4), a fifth "flood" request sheds with the same
    envelope in both packages, another tenant and anonymous traffic still
    queue, and dli_tenant_shed_total{tenant="flood"} reads 1. The fleet's
    lock is held throughout, so the worker admits nothing meanwhile."""
    envelopes = {}
    for name, (mod, fleet) in fleets.items():
        with fleet._cv:
            for i in range(4):
                r = mod._Request(f"fill {i}", dict(KW), tenant="flood")
                r.slo = "standard"
                fleet._queue.append(r)
            fleet._note_queue_locked()
            shed = fleet._enqueue(mod._Request("over", dict(KW), tenant="flood"))
            other = fleet._enqueue(mod._Request("fine", dict(KW), tenant="other"))
            anon = fleet._enqueue(mod._Request("anon", dict(KW)))
            depth = len(fleet._queue)
            # the queue-depth gauge per (SLO class, tenant)
            queued = [_counter(fleet, "dli_slo_queue_depth", slo_class="standard", tenant=t)
                      for t in ("flood", "other", "")]
            fleet._queue.clear()
            fleet._note_queue_locked()
            drained = _counter(fleet, "dli_slo_queue_depth", slo_class="standard",
                               tenant="flood")
        assert other is None and anon is None and depth == 6, name
        assert queued == [4.0, 1.0, 1.0] and drained == 0.0, (name, queued, drained)
        envelopes[name] = shed
        assert _counter(fleet, "dli_tenant_shed_total", tenant="flood") == 1.0, name
        assert _counter(fleet, "dli_tenant_shed_total", tenant="other") == 0.0, name
    assert envelopes["port"] == envelopes["jax"]
    shed = envelopes["port"]
    assert shed["error_type"] == "overloaded" and shed["tenant"] == "flood"
    assert "queue quota (4 of 8)" in shed["error"] and shed["retry_after_s"] >= 0


def _wave(fleet, jobs):
    out = [None] * len(jobs)

    def run(i):
        prompt, tenant = jobs[i]
        out[i] = fleet.submit(prompt, tenant=tenant, max_tokens=6, greedy=True, chat=False)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_weighted_tenants_greedy_tokens_identical_to_jax(fleets):
    """Two weighted tenants (acme 3 : globex 1) and an anonymous request
    whose long prompts share the 64-token prefill grant: every greedy
    token, the echoed tenant and the finish reason are the JAX fleet's,
    and every pool block comes back."""
    jobs = [(" ".join(f"acme{j}" for j in range(40)), "acme"),
            (" ".join(f"globex{j}" for j in range(40)), "globex"),
            ("y " * 90, "acme"), ("short anonymous prompt", None)]
    want = _wave(fleets["jax"][1], jobs)
    got = _wave(fleets["port"][1], jobs)
    for (_, tenant), w, g in zip(jobs, want, got):
        assert w["status"] == g["status"] == "success", (w, g)
        for key in ("response", "tokens_generated", "prompt_tokens", "finish_reason"):
            assert g[key] == w[key], key
        assert g.get("tenant") == w.get("tenant") == tenant
    assert max(g["prefill_chunks"] for g in got) >= 3  # the grant was shared
    # each named tenant's TTFT / TPOT feedback, as the JAX scheduler keeps it
    assert sorted(fleets["port"][1]._sched.tenant_feedback) == sorted(
        fleets["jax"][1]._sched.tenant_feedback) == ["acme", "globex"]
    st = fleets["port"][1].stats()
    assert st["paged"]["free_blocks"] == FLEET["kv_pool_blocks"] - 1
