"""The port's examples (``examples/*_torch.py``) against the reference's
(``examples/*.py``), on the CPU.

Every reference example runs in ONE subprocess (JAX's CPU backend, XLA's
excess precision off, as the bf16 parity tests run the reference: its CPU
backend otherwise skips bf16 roundings), each under ``runpy`` with its
standard output captured; the port's run in this process with ``--device
cpu``.  Where the output depends on the weights (``etl_train``'s losses,
``serve_batched``'s tokens) the port takes the reference's: the subprocess
pickles the tree the reference's ``init_params`` made, and the port's
``init_params`` is patched to return it through ``params_from_jax``.
``etl_train`` trains in bfloat16; both sides run it in float32 here (each
package's ``configs.get`` patched), so the losses compare at the train
parity tests' float32 1e-4 (tests/test_torch_train.py).

What must agree:
  * quickstart: the whole output, byte for byte;
  * pipeline_stream (fused and blocks, async and sync): every line, except
    that the ``engine:`` line is held on the keys both ``info()`` dicts
    have but ``impl`` (the port names its per-block algorithm ``gather``,
    the reference its kernel implementation ``ref``; the port adds
    ``device``, and the per-block engine ``device_densify`` and
    ``transfers``);
  * schema_evolution (1 instance and 4): the control-log lines, the
    cluster line, the final stats and the replay line (the losses are of
    other weights);
  * etl_train: the model line and the ETL stats line, and every loss
    within 1e-4;
  * serve_batched: every line (the tokens).
"""

import ast
import contextlib
import io
import json
import os
import pickle
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs as TC
from repro_torch.core.convert import params_from_jax
from repro_torch.models import model as TM

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
F32 = dict(param_dtype="float32", compute_dtype="float32")

# case: (example, arguments of both runs, float32, the reference's weights)
CASES = {
    "quickstart": ("quickstart", [], False, False),
    "pipeline-fused-async": ("pipeline_stream", [], False, False),
    "pipeline-fused-sync": ("pipeline_stream", ["--sync"], False, False),
    "pipeline-blocks-async": ("pipeline_stream", ["--engine", "blocks"], False, False),
    "pipeline-blocks-sync": ("pipeline_stream", ["--engine", "blocks", "--sync"], False, False),
    "schema": ("schema_evolution", ["--steps", "3"], False, False),
    "schema-4": ("schema_evolution", ["--steps", "3", "--instances", "4"], False, False),
    "etl_train": ("etl_train", ["--steps", "3"], True, True),
    "serve": ("serve_batched", [], False, True),
}

_DRIVER = """
import contextlib, io, json, pickle, runpy, sys
import numpy as np
import jax
import repro.configs as C
from repro.models import model as M

cases, out = json.loads(sys.argv[1]), sys.argv[2]
get, get_smoke, init = C.get, C.get_smoke, M.init_params
F32 = dict(param_dtype="float32", compute_dtype="float32")
results = {}
for name, (path, argv, f32, weights) in cases.items():
    made = []

    def recorded(cfg, key):  # a copy, before a train step donates the tree
        p = init(cfg, key)
        made.append(jax.tree_util.tree_map(np.array, p))
        return p

    M.init_params = recorded
    C.get = (lambda a: get(a).replace(**F32)) if f32 else get
    C.get_smoke = (lambda a: get_smoke(a).replace(**F32)) if f32 else get_smoke
    sys.argv = [path] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    results[name] = buf.getvalue()
    if weights:
        with open(f"{out}/{name}.pkl", "wb") as fh:
            pickle.dump(made[0], fh)
print("RESULTS " + json.dumps(results))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference output, from one subprocess; the weights
    pickled beside them."""
    out = tmp_path_factory.mktemp("ref_examples")
    cases = {name: (str(EXAMPLES / f"{ex}.py"), argv, f32, w)
             for name, (ex, argv, f32, w) in CASES.items()}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_DRIVER), json.dumps(cases),
                           str(out)], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULTS "))
    return json.loads(line[len("RESULTS "):]), out


def run_port(name, monkeypatch, weights_dir=None):
    """The port's example of case ``name`` on the CPU, in this process;
    returns its standard output."""
    ex, argv, f32, weights = CASES[name]
    if f32:
        get, get_smoke = TC.get, TC.get_smoke
        monkeypatch.setattr(TC, "get", lambda a: get(a).replace(**F32))
        monkeypatch.setattr(TC, "get_smoke", lambda a: get_smoke(a).replace(**F32))
    if weights:
        with open(weights_dir / f"{name}.pkl", "rb") as fh:
            tree = pickle.load(fh)
        monkeypatch.setattr(TM, "init_params",
                            lambda cfg, gen=0, *, device="cuda": params_from_jax(tree,
                                                                                 device=device))
    device = [] if ex == "quickstart" else ["--device", "cpu"]
    path = EXAMPLES / f"{ex}_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path)] + argv + device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue()


def _lines(text, *prefixes):
    return [x for x in text.splitlines() if not prefixes or x.startswith(prefixes)]


def test_quickstart_is_byte_identical(reference, monkeypatch):
    ref, _ = reference
    assert run_port("quickstart", monkeypatch) == ref["quickstart"]
    # the text chip_smoke.py's phase 10 holds the card machine's run against
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    assert chip_smoke.QUICKSTART_TEXT == ref["quickstart"]


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("pipeline")])
def test_pipeline_stream_lines(name, reference, monkeypatch):
    ref, _ = reference
    got, want = _lines(run_port(name, monkeypatch)), _lines(ref[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.startswith("engine: "):
            gi, wi = (ast.literal_eval(x[len("engine: "):]) for x in (g, w))
            common = (set(gi) & set(wi)) - {"impl"}
            assert {k: gi[k] for k in common} == {k: wi[k] for k in common}
            assert gi["engine"] == wi["engine"] and len(common) >= 12
        else:
            assert g == w


@pytest.mark.parametrize("name", ["schema", "schema-4"])
def test_schema_evolution_control_log_and_stats(name, reference, monkeypatch):
    ref, _ = reference
    got = run_port(name, monkeypatch)
    keep = ("  [state", "cluster info:", "final ETL stats:", "control-log replay:")
    assert _lines(got, *keep) == _lines(ref[name], *keep)
    assert len(_lines(got, "  [state")) == 5  # every scheduled event, once
    assert "DPM bit-exact" in got


def test_etl_train_stats_and_losses(reference, monkeypatch):
    ref, weights = reference
    got, want = run_port("etl_train", monkeypatch, weights), ref["etl_train"]
    keep = ("model:", "ETL stats:")
    assert _lines(got, *keep) == _lines(want, *keep)

    def losses(text):
        return [float(x.split()[-1]) for x in _lines(text, "step")]

    assert len(losses(got)) == len(losses(want)) == 2
    np.testing.assert_allclose(losses(got), losses(want), rtol=1e-4, atol=1e-4)


def test_serve_batched_tokens(reference, monkeypatch):
    ref, weights = reference
    got = run_port("serve", monkeypatch, weights)
    assert got == ref["serve"]
    assert "completed 8/8 requests" in got
