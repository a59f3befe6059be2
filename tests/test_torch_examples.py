"""The port's example twins on the CPU at reduced steps: the quickstart's
Theorem 4.1 deviations stay at rounding level, its shifted-task loss falls
and its merged tree serves the tuned tree's logits; the sampling twin's
seeded tokens reproduce from run to run and its stop request ends on its
stop id; the metrics twin's tracker sees its preemptions and deadlines;
the serve-while-train twin streams its checkpoints into the live bank and
serves the newest one as a fresh engine would; the method comparison
fine-tunes one base with six methods, and the launcher twin trains, then
resumes from its checkpoint."""
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

from repro_torch.examples import (  # noqa: E402
    peft_comparison, quickstart, serve_metrics, serve_sampling,
    serve_while_train, train_psoft_lm)
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


def test_quickstart_twin(capsys):
    out = quickstart.main(["--device", "cpu", "--pretrain-steps", "6",
                           "--steps", "8"])
    assert out["angle_dev"] < 1e-5 and out["norm_dev"] < 1e-5
    assert out["losses"][-1] < out["losses"][0]
    assert out["merge_dev"] < 1e-4
    assert "Theorem 4.1" in capsys.readouterr().out


def test_sampling_twin_reproduces_its_draws():
    first = serve_sampling.main(["--device", "cpu"])
    again = serve_sampling.main(["--device", "cpu"])
    assert {u: r.generated for u, r in first.items()} == \
        {u: r.generated for u, r in again.items()}
    assert first[1].generated == first[2].generated
    assert first[3].finish_reason == "stop"
    assert len(first[4].logprobs) == len(first[4].generated) == 4


def test_metrics_twin_sees_every_layer():
    tracker = serve_metrics.main(["--device", "cpu"])
    assert tracker.counter("engine/preemptions") >= 1
    assert tracker.counter("engine/slo_met") == 4
    assert tracker.counter("kv/suspends") == tracker.counter("kv/resumes")
    assert tracker.values("sampler/batch_occupancy")


def test_serve_while_train_twin(tmp_path):
    out = serve_while_train.main(["--device", "cpu", "--train-steps", "4",
                                  "--ckpt-dir", str(tmp_path)])
    assert out["inflight"].done and len(out["inflight"].generated) == 24
    assert len(out["applied"]) >= 2 and out["applied"] == \
        sorted(out["applied"])
    ops = [e["op"] for e in out["swaps"] if e["adapter"] == "live"]
    assert ops[0] == "register" and set(ops[1:]) == {"update"}
    assert out["reclaimed"] >= 1 and out["bank_bytes"] > 0
    fresh = ServeEngine(out["base"], out["cfg"], max_len=64, slots=2,
                        device="cpu")
    fresh.register_adapter("live", trainer.adapter_params(out["state"]))
    want = fresh.run([Request(uid=1, prompt=out["live"].prompt,
                              max_new_tokens=8, adapter="live")])
    assert out["live"].generated == want[0].generated


def test_peft_comparison_twin():
    out = peft_comparison.main(["--device", "cpu", "--pretrain-steps", "1",
                                "--steps", "3"])
    rows = {r["method"]: r for r in out["rows"]}
    assert list(rows) == [m for m, _ in peft_comparison.ROWS]
    assert all(r["steps_per_s"] > 0 and r["final_loss"] == r["final_loss"]
               for r in rows.values())
    # PSOFT trains q, alpha and beta: r(r-1)/2 + 2r per linear
    assert rows["psoft"]["trainable"] == 14 * (46 * 45 // 2 + 2 * 46)
    assert rows["lora_xs"]["trainable"] < rows["psoft"]["trainable"] < \
        rows["oft"]["trainable"]


def test_train_psoft_lm_twin(tmp_path, capsys):
    out = train_psoft_lm.main(["--device", "cpu", "--steps", "4",
                               "--resume-steps", "2", "--ckpt",
                               str(tmp_path)])
    assert out["steps"] == 6 and out["loss"] == out["loss"]
    text = capsys.readouterr().out
    assert "resumed from step 4" in text and "done: 2 steps" in text
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000004", "step_00000006"]
