"""The port's Tracker copy against the reference's: a scripted sequence of
records gives the same captures and the same errors, JSONL files cross
between the packages both ways, the trainer's step metrics land the same,
and one preempting, chunking, sampling ``run_stream`` trace gives the
reference's ``engine/``, ``sampler/``, ``kv/`` and ``scheduler/`` counters,
gauges, events and non-timing histograms (spans excluded)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

#: histograms that hold wall-clock seconds: never compared
SPANS = ("engine/decode_step_s", "engine/prefill_s")


def _script(t):
    """Every primitive, steps explicit and inherited, a span, and the two
    refusals; returns the refusal messages."""
    t.count("a")
    t.count("a", 2.5, step=1)
    t.gauge("g", -7.5, step=2)
    t.gauge("g", 3.0)
    for i, v in enumerate((0.5, 2.0, 1.0, 8.0)):
        t.histogram("h", v, step=3 + i)
    t.log({"loss": 2.0, "lr": 1e-3}, step=7)
    t.event("ev", {"uid": 4, "reason": "stop"}, step=8)
    with t.time_block("span", step=9):
        pass
    errors = []
    for bad in (lambda: t.count("a", -1), lambda: t.gauge("g", 1, step=2)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    return errors


def _capture(t):
    return (t.counters, t.gauges,
            {k: v for k, v in t.histograms.items() if k != "span"},
            t.events, t.scalars, len(t.values("span")))


def test_tracker_copy_records_like_the_reference():
    want, got = jobs.InMemoryTracker(), tobs.InMemoryTracker()
    assert _script(got) == _script(want)
    assert _capture(got) == _capture(want)
    assert got.quantile("h", 0.5) == want.quantile("h", 0.5)
    assert got.counters_under("a") == want.counters_under("a")
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert tobs.NOOP.is_noop and tobs.NOOP.time_block("x") is tobs.NULL_SPAN
    assert tobs.CompositeTracker(tobs.NoopTracker()).is_noop
    both = tobs.CompositeTracker(tobs.InMemoryTracker(),
                                 tobs.InMemoryTracker())
    _script(both)
    assert _capture(both.children[0]) == _capture(got)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


@pytest.mark.parametrize("writer,reader", [(tobs, jobs), (jobs, tobs)],
                         ids=["port-to-reference", "reference-to-port"])
def test_jsonl_crosses_between_packages(tmp_path, writer, reader):
    path = str(tmp_path / "run.jsonl")
    with writer.JsonlTracker(path) as t:
        _script(t)
    records = reader.read_jsonl(path)
    assert _strip(records) == _strip(writer.read_jsonl(path))
    replayed = reader.replay(records)
    direct = writer.InMemoryTracker()
    _script(direct)
    assert _capture(replayed)[:5] == _capture(direct)[:5]
    with open(path, "a") as f:
        f.write('{"v": 1, "t": 0, "step": 1, "kind"')
    with pytest.raises(ValueError, match="unparseable"):
        reader.read_jsonl(path)


def test_trainer_log_step_metrics_matches_reference():
    trackers = (jobs.InMemoryTracker(), tobs.InMemoryTracker())
    for tr, metrics in zip(trackers, (
            {"loss": np.float32(2.0), "grad_norm": np.float64(0.5),
             "lr": 1e-4, "per_token": np.zeros((4,))},
            {"loss": torch.tensor(2.0), "grad_norm": torch.tensor(0.5),
             "lr": 1e-4, "per_token": torch.zeros(4)})):
        mod = jtrainer if isinstance(tr, jobs.InMemoryTracker) else ttrainer
        mod.log_step_metrics(tr, 1, metrics, step_time=0.25)
        mod.log_step_metrics(tr, 2, {"loss": 1.5})
    want, got = trackers
    assert got.scalars == want.scalars
    assert "train/per_token" not in got.scalars
    assert got.values("train/step_time_s") == [0.25]


def _trace(ns, vocab):
    """Deadlined high-priority arrivals behind a big low-priority request
    in a 6-page pool, chunked prefill of 4, a shared 16-token prefix, and
    greedy, sampled, logprob and stop rows."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 16).astype(np.int32)
    big = ns.Request(uid=0, prompt=(np.arange(30, dtype=np.int32) * 3 + 1)
                     % vocab, max_new_tokens=12, priority=0,
                     sampling=ns.SamplingParams(temperature=0.9, top_p=0.95,
                                                seed=11, logprobs=2))
    out = [(1, big)]
    for i in range(4):
        user = rng.integers(0, vocab, 3).astype(np.int32)
        sp = (ns.SamplingParams(temperature=0.8, top_k=20, seed=70 + i,
                                stop_token_ids=(int(system[0]),))
              if i % 2 else None)
        out.append((3 + 2 * i, ns.Request(
            uid=1 + i, prompt=np.concatenate([system, user]),
            max_new_tokens=4, priority=1, deadline=14.0, sampling=sp)))
    return out


def _capture_run(eng, tr, ns, vocab):
    done = eng.run_stream(_trace(ns, vocab), max_steps=300)
    assert all(r.done for r in done) and eng.kv.pages_in_use() == 0
    return dict(
        counters={p: tr.counters_under(p)
                  for p in ("engine/", "sampler/", "kv/", "scheduler/")},
        gauges=tr.gauges,
        histograms={k: v for k, v in tr.histograms.items()
                    if k not in SPANS},
        events=[{k: v for k, v in e.items()} for e in tr.events],
        spans={k: len(tr.values(k)) for k in SPANS},
        preemptions=eng.last_run_preemptions)


def test_engine_metrics_match_reference():
    jcfg = jget_config("tiny")
    params = jax.jit(lambda k: jmodel.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    kw = dict(max_len=56, slots=2, page_size=8, num_pages=7,
              prefill_chunk_tokens=4)
    jtr, ttr = jobs.InMemoryTracker(), tobs.InMemoryTracker()
    want = _capture_run(jserve.ServeEngine(params, jcfg, tracker=jtr, **kw),
                        jtr, jserve, jcfg.vocab_size)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    got = _capture_run(tserve.ServeEngine(tparams, get_config("tiny"),
                                          device="cpu", tracker=ttr, **kw),
                       ttr, tserve, jcfg.vocab_size)
    assert got["preemptions"] >= 1
    assert got["counters"]["engine/"]["prefill_chunks"] > 0
    assert got["counters"]["kv/"]["prefix_hit_tokens"] > 0
    for key in ("counters", "gauges", "histograms", "events", "spans"):
        assert got[key] == want[key], key
