"""The port's examples (``examples/torch_*.py``) run end to end on the
CPU at tiny sizes (``--device cpu``; the distributed one with two gloo
ranks; the training one on reduced gemma-2b, checkpoints in
``tmp_path``).  The five run side by side in subprocesses, started once
for the module.
"""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

#: example → (arguments, lines its output must hold)
EXAMPLES = {
    "torch_quickstart": (
        ["--size", "64"],
        ["hmax_40:    maxima suppressed ->", "kernels.ops.erode(16)"]),
    "torch_serve_geodesic": (
        ["--frames", "3", "--size", "64", "--batch", "2", "--mixed-sizes"],
        ["totals: 21 requests", "hit_rate=1.00"]),
    "torch_segment_scribbles": (
        ["--size", "32", "--rounds", "2", "--continuous"],
        ["round 1:", "pinned-asset hits: 3"]),
    "torch_distributed_morphology": (
        ["--rows", "2", "--cols", "1", "--size", "64"],
        ["grid: 2x1 ranks (gloo, cpu)",
         "chain sharded == single-device: True",
         "reconstruct sharded == single-device: True"]),
    "torch_train_lm": (
        ["--steps", "6", "--checkpoint-dir", "{tmp}/ckpt"],
        ["loss ", " -> ", " over 6 steps"]),
}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(REPO / "examples" / f"{name}.py"),
         "--device", "cpu", *(a.format(tmp=tmp) for a in args)], cwd=REPO,
        env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, (args, _) in EXAMPLES.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[name] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(outputs, name):
    rc, stdout, stderr = outputs[name]
    assert rc == 0, stderr[-3000:]
    for line in EXAMPLES[name][1]:
        assert line in stdout, stdout
