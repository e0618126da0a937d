"""The port's examples (``repro_torch.examples``) on the CPU, held against
the JAX package's scripts (``examples/*.py``, imported from their files).

* ``serve_demo``: on the JAX script's reduced tinyllama with the JAX
  parameters carried over (``params_from_jax``) and the port's prompts,
  every greedy token equals the JAX engine's, each where JAX's top-2 logit
  gap exceeds ``GAP`` (a near-tie would let f32 noise pick either); the
  failure paths print the JAX script's lines word for word (the same named
  errors and counters), and the healthy tiles equal the JAX pipeline's bit
  for bit.
* ``train_lm``: the ``llama-100m`` config and its parameter count equal the
  JAX script's; three steps of a reduced config on carried parameters and
  the same data pipeline give JAX's losses within 1e-4 (relative).
* ``schedule_explorer``: ``--table-v`` prints the JAX script's text; the
  model-only search prints its rows under the JAX script's budget (TPU
  VMEM), and under the port's own (the H100's shared memory a block) the
  same winners; a measured search on the CPU writes its row (mode
  ``eager``, device ``cpu``) to the given db only.
* Each ``main`` runs in a subprocess that loads no JAX; ``--kernels cuda``
  with ``--device cpu`` raises ``ValueError``, and the default device
  raises where no GPU is visible."""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro_torch.backend.autotune import default_db_path
from repro_torch.configs import get_config
from repro_torch.core.ubplan import VMEM_BYTES
from repro_torch.examples import schedule_explorer, serve_demo, train_lm
from repro_torch.models.model import params_from_jax, param_count

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
GAP = 1e-4
LOSS_TOL = 1e-4
EXAMPLES = ("serve_demo", "train_lm", "schedule_explorer")
MODULES = {"serve_demo": serve_demo, "train_lm": train_lm,
           "schedule_explorer": schedule_explorer}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- serve_demo ---------------------------------------------------------------


def test_serve_demo_streams_match_jax(capsys):
    from repro.serve import engine as jengine

    cfg_j = jax_get_config("tinyllama_1_1b").reduced(n_layers=4, d_model=128)
    cfg, _ = serve_demo.model(torch.device("cpu"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    pj = jm.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    pt = params_from_jax(_np_tree(pj), "cpu")
    toks = serve_demo.prompts(cfg)
    assert np.array_equal(toks, np.random.default_rng(7).integers(0, cfg.vocab, (4, 8)))

    ej = jengine.ServeEngine(cfg_j, pj, batch_slots=serve_demo.SLOTS, max_seq=serve_demo.MAX_SEQ)
    gaps = []

    def recording(params, cache, tokens, pos):
        logits, cache = jm.decode_step(cfg_j, params, cache, tokens, pos)
        top2 = jnp.sort(logits, axis=-1)[:, -2:]
        gaps.append(np.asarray(top2[:, 1] - top2[:, 0]))
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache

    ej.step_fn = recording
    want = ej.run([jengine.Request(prompt=list(p), max_new=serve_demo.MAX_NEW) for p in toks])
    capsys.readouterr()
    got = serve_demo.greedy(cfg, pt, toks, "eager")
    lines = capsys.readouterr().out.splitlines()
    assert got["deterministic"] and got["tokens"] == 4 * serve_demo.MAX_NEW
    assert len(got["done"]) == len(want) == 4
    for i, (g, w) in enumerate(zip(got["done"], want)):
        assert g.prompt == w.prompt and len(g.generated) == len(w.generated) == serve_demo.MAX_NEW
        for k, tok in enumerate(w.generated):
            gap = float(gaps[len(w.prompt) - 1 + k][i])
            assert gap > GAP, f"slot {i} token {k}: JAX's top-2 gap {gap} is a near-tie"
            assert g.generated[k] == tok, (i, k, g.generated, w.generated)
    assert lines[-1] == "[serve] deterministic: True"


@pytest.fixture(scope="module")
def failure_paths():
    """(the port's result and printed lines, the JAX script's printed
    lines)."""
    import contextlib
    import io

    port, jax_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(port):
        got = serve_demo.failure_paths("cpu", "eager")
    with contextlib.redirect_stdout(jax_out):
        _jax_script("serve_demo").failure_paths()
    return got, port.getvalue().splitlines(), jax_out.getvalue().splitlines()


def test_failure_paths_print_the_jax_lines(failure_paths):
    got, lines, want = failure_paths
    assert lines == want
    assert got["exact"]


def test_failure_paths_errors_and_counters(failure_paths):
    from repro_torch.backend import errors

    got, _, _ = failure_paths
    kinds = {k: type(e) for k, e in got["errors"].items()}
    assert kinds == {"submit": errors.NonFiniteInputError, "quarantine": errors.PoisonedTileError,
                     "deadline": errors.DeadlineExceededError,
                     "backpressure": errors.QueueFullError}
    s = got["stats"]
    assert (s["poisoned_tiles"], s["deadline_misses"], s["validation_rejects"],
            s["backpressure_rejects"], s["served"], s["failed"]) == (1, 1, 1, 1, 7, 2)


def test_failure_paths_healthy_tiles_match_jax(failure_paths):
    from repro.apps.paper_apps import make_app
    from repro.backend import compile_pipeline

    got, _, _ = failure_paths
    app = make_app("gaussian", size=13)
    ref = compile_pipeline(app.pipeline, block_h=4)
    out = app.pipeline.output
    for r, t in zip(got["healthy"], (got["tiles"][0], got["tiles"][2])):
        assert np.array_equal(r.outputs[out], np.asarray(ref.run(t)[out]))


# -- train_lm -----------------------------------------------------------------


def test_llama_100m_config_matches_jax():
    want = dataclasses.replace(
        jax_get_config("tinyllama_1_1b"), name="llama-100m",
        n_layers=12, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560, vocab=32000,
    )
    cfg = train_lm.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count()
    from repro_torch.models import init_params

    assert param_count(init_params(cfg, None, torch.float32, "meta")) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: jm.init_params(want, jax.random.PRNGKey(0), jnp.float32))))


def test_train_lm_reduced_steps_match_jax(capsys):
    """Three steps of the JAX script's step (AdamW lr 1.5e-3, 20 warm-up
    steps, 2 microbatches, kv_chunk 64, remat) on a reduced config, batch
    2, seq 16, from the same parameters and the same data pipeline."""
    from repro.train import AdamWConfig as JAdamW, DataPipeline as JData
    from repro.train import TrainState as JState, adamw_init as jinit, make_train_step as jstep

    over = dict(n_layers=2, d_model=64, vocab=512)
    cfg_j = jax_get_config("tinyllama_1_1b").reduced(**over)
    cfg = get_config("tinyllama_1_1b").reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    params = jm.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    step = jax.jit(jstep(cfg_j, JAdamW(lr=1.5e-3, warmup_steps=20), microbatches=2,
                         kv_chunk=64, remat=True))
    state = JState(params, jinit(params), jax.random.PRNGKey(1))
    data = JData(cfg_j.vocab, 2, 16, seed=0)
    want = []
    try:
        for _ in range(3):
            state, met = step(state, {k: jnp.asarray(v) for k, v in next(data).items()})
            want.append(float(met["loss"]))
    finally:
        data.close()
    capsys.readouterr()
    got = train_lm.train(cfg, params_from_jax(_np_tree(params), "cpu"), steps=3, batch=2,
                         seq=16, kernels="eager", generator=torch.Generator().manual_seed(1))
    lines = capsys.readouterr().out.splitlines()
    assert len(got["losses"]) == 3
    for g, w in zip(got["losses"], want):
        assert abs(g - w) <= LOSS_TOL * abs(w), (got["losses"], want)
    assert lines[0].startswith("[train_lm] step    0  loss ")
    assert lines[-1].startswith("[train_lm] loss ") and got["verdict"] in lines[-1]


# -- schedule_explorer ----------------------------------------------------------


def _jax_main_lines(capsys, argv):
    mod = _jax_script("schedule_explorer")
    capsys.readouterr()
    assert mod.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _port_lines(capsys, argv):
    capsys.readouterr()
    res = schedule_explorer.main(argv + ["--device", "cpu", "--kernels", "eager"])
    assert res["rc"] == 0
    return res, capsys.readouterr().out.splitlines()


def test_table_v_matches_jax(capsys):
    want = _jax_main_lines(capsys, ["--table-v"])
    res, got = _port_lines(capsys, ["--table-v"])
    assert got == want
    assert [r["cycles"] for r in res["table"]] == [4112, 4112, 4112, 2064, 16400, 4110]


def test_no_measure_rows_match_jax_under_its_budget(capsys, monkeypatch):
    """With the planner's default budget set to the TPU VMEM's, as the JAX
    package plans, the model-only rows are the JAX script's."""
    from repro_torch.backend import runner

    want = _jax_main_lines(capsys, ["--no-measure", "--no-db"])
    monkeypatch.setitem(runner._PLAN_KWARG_DEFAULTS, "vmem_budget", VMEM_BYTES)
    _, got = _port_lines(capsys, ["--no-measure", "--no-db"])
    assert got == want and len(got) == 4


def test_no_measure_winners_under_the_h100_budget(capsys):
    """The port's default budget (227 KiB a block) picks the JAX winners;
    harris' and unsharp's rows are the JAX script's, matmul's model cycles
    move with its resident K chunk (525104 against JAX's 527024)."""
    want = _jax_main_lines(capsys, ["--no-measure", "--no-db"])
    res, got = _port_lines(capsys, ["--no-measure", "--no-db"])
    assert got[:3] == want[:3]
    assert got[3].split("(model")[0] == want[3].split("(model")[0]
    assert res["results"]["matmul"].schedule == {"block_h": 16}


def test_measured_cpu_search_writes_only_the_given_db(capsys, tmp_path):
    import json

    default = Path(default_db_path())
    before = default.stat().st_mtime_ns if default.exists() else None
    db = tmp_path / "db.json"
    res, got = _port_lines(capsys, ["--apps", "gaussian", "--db", str(db)])
    assert res["db"] == str(db) and got[1].startswith("gaussian")
    entries = json.loads(db.read_text())["entries"]
    assert len(entries) == 1
    (row,) = entries.values()
    assert row["mode"] == "eager" and row["device"] == "cpu"
    assert res["results"]["gaussian"].warm_us <= res["results"]["gaussian"].heuristic_warm_us
    assert (default.stat().st_mtime_ns if default.exists() else None) == before


# -- entry points -----------------------------------------------------------------

SUBPROCESS_ARGV = {
    "serve_demo": [],
    "train_lm": ["--steps", "1", "--batch", "2", "--seq", "8"],
    "schedule_explorer": ["--no-measure", "--no-db"],
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_runs_without_jax(name):
    argv = SUBPROCESS_ARGV[name] + ["--device", "cpu", "--kernels", "eager"]
    code = (
        "import sys\n"
        f"from repro_torch.examples import {name}\n"
        f"res = {name}.main({argv!r})\n"
        "assert res\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('EXAMPLE_OK')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0 and "EXAMPLE_OK" in res.stdout, res.stderr[-3000:]


@pytest.mark.parametrize("name", EXAMPLES)
def test_kernels_cuda_on_the_cpu_raises(name):
    with pytest.raises(ValueError, match="--kernels cuda needs --device cuda"):
        MODULES[name].main(["--device", "cpu"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_without_a_gpu_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        MODULES[name].main(["--kernels", "eager"])
