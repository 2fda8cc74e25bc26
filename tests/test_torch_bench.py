"""The measurement entry points (styl3r_tpu_torch/bench/) on the CPU against
the JAX scripts they port: bench.py, scripts/bench_train_step.py and
scripts/profile_stages.py.

The scene must equal __graft_entry__._example_batch array by array; the
serve record carries bench.py's keys, its FLOPs are utils/flops.py's, and
its live pairs and pair slots equal the JAX forward's on the same weights
and scene (exact integers). Times on the CPU are host times, so only their
presence and sign are checked here."""

import ast
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _example_batch
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu.utils import flops as jflops
from styl3r_tpu_torch.bench import common, serve, stages, timing, train_step
from styl3r_tpu_torch.bench.batch import example_batch
from styl3r_tpu_torch.models.styl3r import Styl3rModel as TModel
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_torch_model import ROOT, TINY, draw_params

# bench.py:244-254 and utils/flops.py::mfu's keys.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "live_pairs_max", "pair_slots", "tflops", "peak_tflops",
              "mfu", "model_gflops"}
# profile_stages.py's stages that the port has.
STAGES = ["backbone", "backbone+stylizer", "predict (enc+sty+heads+adapter)", "project+bin+sort", "project only",
          "project+bin (no sort)", "pack_attrs (gather)", "composite kernel only", "render (proj+sort+composite)",
          "full forward", "bwd:render fwd+bwd", "bwd:composite kernel fwd+bwd",
          "bwd:pack_attrs fwd+bwd (gather+scatter)"]
ABSENT = ["render unbatched (no vmap)", "bwd:scatter_window_grads only", "bwd:gather_window_grads only",
          "bwd:pack_attrs fwd+bwd (grouped)"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the loops of small CPU ops here oversubscribe
    the host under the Tier-1 command's 6 workers otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def serving_model():
    """A model for serve.py's and stages.py's --tiny runs, built once for
    both: --tiny's trunk widths (which the FLOP count reads) with the heads
    cut too, so that the file stays fast."""
    return common.serving_model(torch.device("cpu"), common.TINY_HEADS)


def last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("caller", ["bench.batch", "chip_smoke"])
def test_example_batch_equals_jax(caller):
    """Every array of the scene equals JAX's, the targets after the first
    translated 0.2 along x included; with targets dropped the generator
    still ends where JAX's does."""
    b, v, hw, t = 2, 3, 32, 3
    ref = _example_batch(np.random.default_rng(3), b=b, v=v, h=hw, w=hw, t=t, style_hw=hw)
    if caller == "chip_smoke":
        ours = chip_smoke.example_batch(3, "cpu", v=v, hw=hw, t=t, b=b, targets=True)
    else:
        ours = example_batch(np.random.default_rng(3), b, v, hw, hw, t, hw, "cpu")
    for name in ref._fields[:8]:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    ext = ours.target_extrinsics.numpy()
    assert (ext[:, 0, 0, 3] == 0).all() and (ext[:, 1:, 0, 3] == np.float32(0.2)).all()

    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    _example_batch(rng_j, b=1, v=2, h=16, w=16, t=1, style_hw=16)
    assert example_batch(rng_t, 1, 2, 16, 16, 1, 16, "cpu", targets=False).target_images is None
    assert rng_t.uniform() == rng_j.uniform()


def test_serve_record_has_bench_keys_and_flops(serving_model, capsys, tmp_path):
    extra = tmp_path / "extra.json"
    record = serve.main(["--cpu", "--tiny", "--iters", "2", "--extra", str(extra)], model=serving_model)
    printed = last_json(capsys)
    assert printed == record == json.loads(extra.read_text())
    assert BENCH_KEYS <= set(record)
    assert {"latency_ms", "encoder_ms", "render_ms", "host_syncs", "device", "card"} <= set(record)
    total = jflops.styl3r_forward_flops(b=1, v=2, h=64, w=64, style_hw=64, n_targets=1, pair_cap_per_gaussian=2,
                                        **{k: common.TINY[k] for k in common.FLOPS_DIMS})["total"]
    assert record["model_gflops"] == round(total / 1e9, 1)
    assert 0 <= record["live_pairs_max"] <= record["pair_slots"]
    assert record["value"] > 0 and record["latency_ms"] > 0 and "plain compositor" in record["metric"]
    # No device metric from a CPU run.
    assert record["device"] == "cpu" and record["mfu"] is None and record["host_syncs"] is None


def test_serve_needs_a_card_unless_told_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        serve.main(["--tiny"])
    with pytest.raises(RuntimeError):
        serve.main(["--cpu", "--tiny", "--impl", "pallas"])


def test_serve_pairs_match_jax():
    """The serve measurement's live pairs and pair slots on flax weights
    carried across equal the JAX forward's (impl="jnp") on the same scene."""
    hw = 32
    render = dict(max_tiles_per_gaussian=8, max_per_tile=512, pair_cap_per_gaussian=2)
    jm = JModel(sh_degree=0, **TINY)
    jbatch = _example_batch(np.random.default_rng(0), b=1, v=2, h=hw, w=hw, t=1, style_hw=hw)
    params = draw_params(jm, jbatch, seed=0)
    _, jout = jax.jit(lambda p, bt: jm.forward(p, bt, (hw, hw), impl="jnp", **render))(
        jax.tree.map(jnp.asarray, params), jbatch)
    tm = TModel(sh_degree=0, device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(params))
    batch = example_batch(np.random.default_rng(0), 1, 2, hw, hw, 1, hw, "cpu")
    res = serve.measure(tm, batch, (hw, hw), render, iters=1)
    assert res["live_pairs_max"] == int(np.asarray(jout.live_pairs).max()) > 0
    assert res["pair_slots"] == int(np.asarray(jout.pair_slots).min())


def test_train_step_keys_follow_the_jax_grammar(capsys):
    cases = ["32:jnp", "32:pallas:b2:stage2"]
    results = train_step.main(["--cpu", "--tiny", "--cases", ",".join(cases)])
    assert last_json(capsys) == results
    for case in cases:
        assert results[case] > 0 and results[f"{case}:examples_per_sec_chip"] > 0
        assert 0 < results[f"{case}:live_pairs"] <= results[f"{case}:pair_slots"]
        assert np.isfinite(results[f"{case}:loss"]) and results[f"{case}:grad_sq_norm"] > 0
    assert results["32:pallas:b2:stage2:route"] == "plain compositor"  # --cpu: no kernel
    assert not [k for k in results if "v5e8" in k or "pallas_speedup" in k]
    assert train_step.parse_case("256:pallas:b2:stage2") == train_step.Case(256, "pallas", 2, "stage2")
    assert train_step.parse_case("128:jnp") == train_step.Case(128, "jnp", 1, "stage1")


def test_stages_report(serving_model, capsys):
    report = stages.main(["--cpu", "--tiny", "--iters", "1"], model=serving_model)
    assert last_json(capsys) == json.loads(json.dumps(report))
    assert list(report["per_scene_ms"]) == STAGES
    absent = {a["name"]: a["reason"] for a in report["absent"]}
    assert all(absent.get(name) for name in ABSENT) and not set(absent) & set(STAGES)
    assert set(report["derived_ms"]) == {"stylizer", "heads+adapter", "composite"}

    def numbers(x):
        if isinstance(x, dict):
            return [n for v in x.values() for n in numbers(v)]
        if isinstance(x, list):
            return [n for v in x for n in numbers(v)]
        return [x] if isinstance(x, float) else []

    values = numbers(report)
    assert values and not any(np.isnan(values))
    assert all(t > 0 for t in report["per_scene_ms"].values())


def test_trace_breakdown_on_a_known_trace():
    """Two calls: kernels at [0, 10], [5, 20] (overlapping), [30, 40] and
    [100, 110] us; host ops around them, the innermost naming each gap."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("cpu_op", "aten::outer", -10, 130), x("cpu_op", "aten::item", 22, 6), x("cpu_op", "aten::mul", 45, 50),
        x("kernel", "k_a", 0, 10), x("kernel", "k_b", 5, 15), x("kernel", "k_a", 30, 10), x("kernel", "k_c", 100, 10),
        {"ph": "i", "cat": "kernel", "name": "k_marker", "ts": 50},  # not a duration event: ignored
    ]
    out = timing.trace_breakdown(events, calls=2, top=2)
    busy, window = 20 + 10 + 10, 130
    assert out["device_ms"] == busy / 2 / 1e3 and out["window_ms"] == window / 2 / 1e3
    assert out["busy_share"] == busy / window and out["kernels_per_call"] == 2.0
    assert out["top_kernels"][0] == {"name": "k_a", "ms_per_call": 20 / 2 / 1e3, "launches_per_call": 1.0}
    assert [k["name"] for k in out["top_kernels"]] == ["k_a", "k_b"]
    assert out["gaps"] == [{"ms": 60 / 1e3, "host_op": "aten::mul", "span": None},
                           {"ms": 10 / 1e3, "host_op": "aten::item", "span": None}]  # no styl3r/ range here
    assert timing.trace_breakdown([x("kernel", "k", 0, 4)], calls=1)["gaps"] == []


def test_back_to_back_chains_each_call_on_the_last():
    seen = []

    def step(carry):
        seen.append(float(carry))
        return carry + 1.0

    assert timing.back_to_back_ms(step, 3, torch.device("cpu"), warm=1) >= 0
    assert seen == [0.0, 1.0, 2.0, 3.0]
    assert timing.host_syncs(lambda: None) is None and timing.device_breakdown(lambda: None, 1) is None


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "styl3r_tpu_torch").rglob("*.py") if "bench" not in p.parts))
def test_model_code_never_imports_bench(path):
    package = ".".join(path.split("/")[:-1])
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.ImportFrom):
            base = package.split(".")[: len(package.split(".")) - node.level + 1] if node.level else []
            module = ".".join([*base, *(node.module or "").split(".")]).strip(".")
            names = [module] + [f"{module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        assert not any(n.startswith("styl3r_tpu_torch.bench") for n in names), (path, names)
