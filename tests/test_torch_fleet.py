"""The port's serving fleet (``elephas_tpu_torch/fleet``) against the JAX
package's on the CPU.

- Traffic: seeded ``TrafficModel`` traces equal the reference's request for
  request (the reference's chaos scenario, the defaults, and the card's
  GPT-2-width scenario), JSON and ``scaled`` included; ``zipf_weights``
  and the ``SimClock``.
- Policy: ``FleetPolicy`` decisions (dispatch and shed, in order) over one
  trace with rate limits and an ITL floor equal the reference's.
- The reference's pinned chaos scenario (``tests/fleet/test_chaos_fleet.py``:
  seed 3, 4 tenants, half sampled, partition 0 killed at 2.0 s, a
  replacement joining at 2.5 s), the port dense and paged (``kv.check()``
  after every fleet step), each against the reference's dense run (whose
  streams its own paged test pins equal to its paged run's): the same
  placements, migrations, terminal states, finish times and deadline
  misses, greedy tokens equal, the reference's miss bound, and every
  migrated or surviving stream equal to the port's undisturbed run. Sampled rows draw from the
  port's (seed, position)-keyed Gumbel sampler, a logged departure, so
  their tokens are not compared with the reference's.
- Retirement, weight fan-out (``swap_params``, ``router_sink``, late
  joiners) and the autoscaler's events equal the reference's.
- ``FleetRouter._engine_adapter`` over paged ``MultiTenantLM`` partitions:
  tenants ride their adapters as in the reference, and their greedy tokens
  equal the reference fleet's.

Both packages run on one ``SimClock`` each; no test sleeps.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax.numpy as jnp
import numpy as np
import pytest

from elephas_tpu import fleet as JF
from elephas_tpu.models import lora as jl
from elephas_tpu.models.transformer import TransformerLM as JaxLM
from elephas_tpu.serving import ServingEngine as JaxEngine
from elephas_tpu_torch import fleet as TF
from elephas_tpu_torch.models import MultiTenantLM, TransformerLM, from_jax_params
from elephas_tpu_torch.serving import AdmissionError, ServingEngine
from elephas_tpu_torch.streaming import params_to_list

CFG = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
CHAOS_TRACE = dict(seed=3, base_rps=4.0, duration_s=12.0, n_tenants=4,
                   sampled_frac=0.5, burst_amp=2.0)
CHAOS = [{"t": 2.0, "op": "kill", "pid": 0}, {"t": 2.5, "op": "join"}]
STEP_DT = 0.05
MISS_BOUND = 0.1


@pytest.fixture(scope="module")
def pair():
    """The reference's model and weights and the port's copy of them."""
    jm = JaxLM(**CFG)
    np_params = {k: np.asarray(v) for k, v in jm.init(seed=1).items()}
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tm = TransformerLM(**CFG, device="cpu")
    return (jm, jp), (tm, from_jax_params(np_params, device="cpu"))


def _ref(pair):
    return JF, JaxEngine, {}, pair[0]


def _port(pair):
    return TF, ServingEngine, {"device": "cpu"}, pair[1]


def _router(side, clock, *, n=2, paged=False, n_slots=4, lease_s=0.5):
    F, Eng, extra, (model, p) = side

    def factory(pid):
        return Eng(model, p, n_slots=n_slots, max_queue=8, paged=paged, page_size=4,
                   clock=clock, perf_clock=clock, **extra)

    return F.FleetRouter(factory, n, policy=F.FleetPolicy(), clock=clock, lease_s=lease_s)


def _replay(side, trace, *, paged, chaos, check=False):
    """``run_trace``'s loop, with ``kv.check()`` after every fleet step when
    ``check`` (the reference test's hand-rolled loop)."""
    F = side[0]
    clock = F.SimClock()
    router = _router(side, clock, paged=paged)
    if not check:
        return router, F.run_trace(router, trace, clock=clock, step_dt=STEP_DT,
                                   chaos=chaos)
    pending = sorted(trace.requests, key=lambda r: r.arrival_s)
    events = sorted(chaos or [], key=lambda e: e["t"])
    i = e = steps = 0
    while True:
        now = clock()
        while e < len(events) and events[e]["t"] <= now:
            ev = events[e]
            e += 1
            (router.kill_partition(ev["pid"]) if ev["op"] == "kill"
             else router.join_partition())
        while i < len(pending) and pending[i].arrival_s <= now:
            router.submit(pending[i])
            i += 1
        router.step()
        for pid in router.partition_ids():
            router._engines[pid].kv.check()
        if i >= len(pending) and e >= len(events) and router.active == 0:
            break
        clock.advance(STEP_DT)
        steps += 1
        assert steps < 20000
    return router, router.snapshot()


# -- traffic -------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    {},
    CHAOS_TRACE,
    dict(CHAOS_TRACE, vocab=50257, prompt_len_median=64.0, prompt_len_max=256,
         max_new_median=32.0, max_new_max=64),
    dict(seed=11, base_rps=9.0, duration_s=20.0, n_tenants=8, zipf_a=1.6,
         batch_deadline_s=30.0, interactive_tenants=3),
], ids=["defaults", "chaos", "card", "skewed"])
def test_traffic_traces_match_reference(cfg):
    want = JF.TrafficModel(**cfg).generate()
    got = TF.TrafficModel(**cfg).generate()
    assert got.to_json() == want.to_json()
    assert got.tenants() == want.tenants() and got.offered_rps == want.offered_rps
    assert got.scaled(2.5).to_json() == want.scaled(2.5).to_json()
    back = TF.Trace.from_json(got.to_json())
    assert [r.to_dict() for r in back] == [r.to_dict() for r in got]
    np.testing.assert_array_equal(TF.traffic.zipf_weights(7, 1.3),
                                  JF.traffic.zipf_weights(7, 1.3))
    clock = TF.SimClock(1.5)
    assert clock() == 1.5 and clock.advance(0.25) == 1.75 and clock() == 1.75
    with pytest.raises(ValueError):
        clock.advance(-1.0)


# -- policy --------------------------------------------------------------------


def test_fleet_policy_decisions_match_reference():
    """The same trace fed to both policies on one schedule of clock ticks:
    every dispatch and shed, in order, and every tenant's snapshot agree."""
    trace = JF.TrafficModel(seed=7, base_rps=12.0, duration_s=6.0, n_tenants=5,
                            max_new_max=24, deadline_base_s=1.0,
                            deadline_per_token_s=0.05).generate()
    kw = dict(quantum=6.0, itl_estimate_s=0.05, max_queue_per_tenant=5,
              rate_limits={1: (20.0, 30.0), 3: (5.0, 10.0)})
    logs = []
    for F in (JF, TF):
        policy, log = F.FleetPolicy(**kw), []
        reqs = [F.TraceRequest.from_dict(r.to_dict()) for r in trace]
        i, now = 0, 0.0
        while now < 9.0:
            while i < len(reqs) and reqs[i].arrival_s <= now:
                log.append(("submit", reqs[i].request_id, policy.submit(reqs[i], now)))
                i += 1
            for _ in range(1):      # one dispatch slot a tick
                decision = policy.poll(now)
                if decision is None:
                    break
                log.append((decision[0], decision[1].request_id))
            now = round(now + 0.1, 6)
        logs.append((log, policy.snapshot()))
    assert logs[1] == logs[0]
    kinds = {entry[0] for entry in logs[0][0]}
    assert {"dispatch", "shed"} <= kinds


# -- the pinned chaos scenario -------------------------------------------------


@pytest.fixture(scope="module")
def chaos_runs(pair):
    """Each package's run of the chaos scenario once: the reference's on
    dense partitions (its own slow test pins its paged run's streams equal
    to them, and placements, lengths and deadlines do not depend on the
    cache) and the port's undisturbed dense run."""
    trace = JF.TrafficModel(**CHAOS_TRACE).generate()
    ptrace = TF.Trace.from_json(trace.to_json())
    return (trace, _replay(_ref(pair), trace, paged=False, chaos=CHAOS), ptrace,
            _replay(_port(pair), ptrace, paged=False, chaos=None)[0])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chaos_scenario_matches_reference(pair, chaos_runs, paged):
    trace, (jrouter, jsnap), ptrace, base = chaos_runs
    router, snap = _replay(_port(pair), ptrace, paged=paged, chaos=CHAOS, check=paged)
    # nothing lost; the same membership story, SLO and tenant accounting
    f = snap["fleet"]
    assert f["done"] == len(trace) and f["queued"] == 0 and f["epoch_changes"] >= 2
    assert snap["fleet"] == jsnap["fleet"]
    assert snap["slo"] == jsnap["slo"]
    assert {t: {k: v for k, v in row.items() if k != "tokens"}
            for t, row in snap["tenants"].items()} == \
        {t: {k: v for k, v in row.items() if k != "tokens"}
         for t, row in jsnap["tenants"].items()}
    slo = snap["slo"]
    assert slo["deadline_missed"] / slo["deadline_done"] <= MISS_BOUND
    # per request: the placement, migrations, terminal state and finish
    # time are the reference's; greedy rows emit the reference's tokens
    want, got = jrouter.results(), router.results()
    assert set(got) == set(want)
    migrated = [rid for rid, st in got.items() if st.migrations]
    assert migrated and router.migrations == jrouter.migrations >= 1
    n_greedy = 0
    for rid, st in want.items():
        mine = got[rid]
        assert (mine.partition, mine.migrations, mine.finish_reason, mine.finished_at,
                mine.first_token_at, len(mine.tokens)) == \
            (st.partition, st.migrations, st.finish_reason, st.finished_at,
             st.first_token_at, len(st.tokens)), rid
        if st.req.temperature == 0.0:
            n_greedy += 1
            assert mine.tokens == st.tokens, rid
    assert n_greedy >= 20
    # within the port, migrated and surviving streams (sampled ones too)
    # equal the undisturbed run's (the paged engine's streams are the dense
    # engine's on the CPU)
    for rid, st in base.results().items():
        assert got[rid].tokens == st.tokens, rid


def test_retire_and_weight_fan_out_match_reference(pair):
    """Graceful retirement migrates without a lease wait; ``router_sink``
    fans a publication out to every live partition and to a partition that
    joins later; the tokens after the swap are the reference's."""
    (jm, jp), (tm, tp) = pair
    p2_np = {k: np.asarray(v) for k, v in jm.init(seed=2).items()}
    wire = params_to_list(p2_np)
    out = []
    for side, template in ((_ref(pair), jp), (_port(pair), tp)):
        F = side[0]
        clock = F.SimClock()
        router = _router(side, clock, n=2, lease_s=2.0)
        reqs = [F.TraceRequest(request_id=f"r{i}", arrival_s=0.0, tenant=i % 2,
                               prompt=[(3 * i + j) % 17 for j in range(4 + i)],
                               max_new=6) for i in range(5)]
        for r in reqs:
            router.submit(r)
        router.step()
        router.step()
        router.retire_partition(1)
        # version 7 of the other weights, bridged through each package's
        # own template
        sink = F.router_sink(router, template)
        sink(wire, 7)
        pid = router.join_partition()
        for _ in range(400):
            if not router.active:
                break
            router.step()
            clock.advance(STEP_DT)
        late = router._engines[pid]
        out.append(({rid: (s.tokens, s.migrations, s.partition)
                     for rid, s in router.results().items()},
                    late.weights_version, router.migrations,
                    router.snapshot()["fleet"]))
    assert out[1] == out[0]
    assert out[1][1] == 7 and out[1][2] >= 1


def test_autoscaler_events_match_reference(pair):
    trace = JF.TrafficModel(seed=5, base_rps=6.0, duration_s=6.0, n_tenants=4).generate()
    out = []
    for side in (_ref(pair), _port(pair)):
        F = side[0]
        clock = F.SimClock()
        router = _router(side, clock, n=1, n_slots=2, lease_s=2.0)
        scaler = F.Autoscaler(router, min_partitions=1, max_partitions=4,
                              cooldown_s=1.0, queue_high=3.0)
        snap = F.run_trace(router, F.Trace.from_json(trace.to_json()), clock=clock,
                           step_dt=STEP_DT, autoscaler=scaler)
        out.append((scaler.events, snap["fleet"], snap["slo"], router.n_live))
    assert out[1] == out[0]
    actions = {e["action"] for e in out[1][0]}
    assert actions == {"up", "down"} and out[1][3] == 1


def test_duplicate_request_id_rejected(pair):
    router = _router(_port(pair), TF.SimClock(), n=1)
    router.submit(TF.TraceRequest("dup", 0.0, 0, [1, 2], 2))
    with pytest.raises(AdmissionError):
        router.submit(TF.TraceRequest("dup", 0.0, 0, [3, 4], 2))


def test_engine_adapter_over_paged_multi_tenant_partitions():
    """Paged ``MultiTenantLM`` partitions: a tenant below ``n_adapters``
    rides its adapter, others the base weights, in both packages; greedy
    fleet tokens equal the reference fleet's, and each equals a dense
    engine of the base model on the tenant's merged weights."""
    mt_kw = dict(n_adapters=3, lora_rank=4)
    jm = jl.MultiTenantLM(**CFG, **mt_kw)
    np_params = jm.randomize_adapter(jm.randomize_adapter(jm.init(seed=1), 1, seed=7),
                                     2, seed=8)
    mt = MultiTenantLM(**CFG, **mt_kw, device="cpu")
    tp = from_jax_params(np_params, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 17, size=(n,)).tolist() for n in (7, 8, 6, 5, 8)]
    results = []
    for F, Eng, extra, model, p in ((JF, JaxEngine, {}, jm, jp),
                                    (TF, ServingEngine, {"device": "cpu"}, mt, tp)):
        clock = F.SimClock()
        router = F.FleetRouter(
            lambda pid: Eng(model, p, n_slots=4, paged=True, page_size=8, clock=clock,
                            perf_clock=clock, **extra), 2, clock=clock, lease_s=2.0)
        eng = router._engines[0]
        results.append([router._engine_adapter(eng, t) for t in range(6)])
        reqs = [F.TraceRequest(f"r{i}", 0.0, i, prompt, 8) for i, prompt in enumerate(prompts)]
        F.run_trace(router, F.Trace(requests=reqs), clock=clock, step_dt=STEP_DT)
        results.append({rid: s.tokens for rid, s in router.results().items()})
    assert results[2] == results[0] == [0, 1, 2, 0, 0, 0]
    assert results[3] == results[1]
    base = mt.base_model()
    for i, prompt in enumerate(prompts):
        aid = i if i < 3 else 0
        eng = ServingEngine(base, mt.merged_params(tp, aid), n_slots=1, device="cpu")
        rid = eng.submit(np.asarray(prompt, np.int32), 8)
        assert eng.drain()[rid].tokens == results[3][f"r{i}"], i
