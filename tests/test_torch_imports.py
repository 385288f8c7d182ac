"""Guards of the port's boundary: ``repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``repro``, and the entry points
run on the GPU unless the caller asks for the CPU — without a GPU they
raise instead of quietly running on the CPU.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_import_everything_without_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_import_in_port_sources():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "examples").glob("torch_*.py")))
    assert len(files) > 15
    assert {PORT / "core" / "distributed.py"} | {
        REPO / "examples" / f"torch_{name}.py" for name in (
            "quickstart", "serve_geodesic", "segment_scribbles",
            "distributed_morphology", "train_lm")} <= set(files)
    assert {PORT / "gdt" / "__init__.py", PORT / "gdt" / "reference.py",
            PORT / "kernels" / "gdt_chain.py", PORT / "opt" / "__init__.py",
            PORT / "opt" / "engine.py", PORT / "opt" / "rules.py"} <= set(files)
    assert {PORT / "serve" / f"{name}.py" for name in (
        "__init__", "errors", "faults", "loop", "metrics", "cache",
        "bucketer", "registry", "executor", "service",
        "continuous")} <= set(files)
    assert {PORT / "analysis" / f"{name}.py" for name in (
        "__init__", "findings", "halo", "plans", "dtypes", "cachekeys",
        "indexmaps", "rewrites", "verifier", "lint")} <= set(files)
    assert {PORT / "baselines" / f"{name}.py" for name in (
        "__init__", "naive", "vhgw", "pixel_pump",
        "queue_reconstruction")} <= set(files)
    assert {PORT / "configs" / f"{name}.py" for name in (
        "__init__", "base", "registry", "shapes", "gemma_2b", "gemma_7b",
        "gemma3_27b", "qwen2_5_32b", "chameleon_34b", "deepseek_moe_16b",
        "arctic_480b", "zamba2_7b", "xlstm_350m",
        "seamless_m4t_large_v2")} <= set(files)
    assert {PORT / "models" / f"{name}.py" for name in (
        "__init__", "layers", "attention", "model", "decode",
        "convert", "moe")} | {PORT / "launch" / "__init__.py",
                       PORT / "launch" / "serve.py"} <= set(files)
    assert {PORT / path for path in (
        "optim/__init__.py", "optim/adamw.py", "data/synthetic.py",
        "train/__init__.py", "train/steps.py", "train/loop.py",
        "checkpoint/__init__.py", "checkpoint/manager.py",
        "launch/train.py", "optim/compression.py", "launch/mesh.py",
        "launch/analytic.py", "models/partitioning.py",
        "launch/sharding.py", "launch/op_count.py", "launch/dryrun.py",
        "launch/roofline.py", "launch/link_latency.py")} <= set(files)
    offenders = [(f.relative_to(REPO).as_posix(), root) for f in files
                 for root in _imported_roots(f)
                 if root in ("jax", "jaxlib", "repro")]
    assert not offenders


def test_default_device_is_the_gpu_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default runs there")
    from repro_torch import gdt, serve
    from repro_torch.api import E, compile
    from repro_torch.core import operators
    from repro_torch.kernels import ops

    x = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile(E.erode(2, E.input("f")), x.shape, x.dtype)(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile(E.erode(2, E.input("f")), (8, 8), np.uint8, "torch")
    # a CPU tensor does not choose the CPU: the sugar defaults to the GPU
    for call in (lambda: operators.hmax(x, 3),
                 lambda: operators.asf(x, 1, "torch"),
                 lambda: ops.erode(x, 2),
                 lambda: ops.reconstruct(x, x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # so do the engine entry points, whatever device their input is on
    engine = {
        "morph_chain": lambda **kw: ops.morph_chain(x, 2, **kw),
        "geodesic_chain": lambda **kw: ops.geodesic_chain(x, x, 2, **kw),
        "reconstruct_with_stats": lambda **kw: ops.reconstruct_with_stats(
            x, x, **kw)[0],
        "qdt_planes": lambda **kw: ops.qdt_planes(x, **kw)[0],
        "qdt": lambda **kw: operators.qdt(x, **kw),
        "qdt-max_s": lambda **kw: operators.qdt(x, 3, **kw),
        "ops.gdt": lambda **kw: ops.gdt(x.float(), x.float(), **kw),
        "gdt.gdt": lambda **kw: gdt.gdt(x.float(), x.float(), **kw),
    }
    for name, call in engine.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu").device.type == "cpu", name
    # asking for the CPU runs there
    assert operators.hmax(x, 3, device="cpu").device.type == "cpu"
    assert ops.erode(x, 2, device="cpu").device.type == "cpu"
    # the service (continuous too) and its executor run on the GPU
    # unless asked
    for cont in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.Service(continuous=cont)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Executor(serve.ServeMetrics())
    assert serve.Executor(serve.ServeMetrics(),
                          device="cpu").device.type == "cpu"
    svc = serve.Service(device="cpu", max_delay_ms=0.0)
    assert svc.submit("erode", x.numpy(), params={"s": 2}).result(
        ).device.type == "cpu"
    svc = serve.Service(device="cpu", max_delay_ms=0.0, continuous=True)
    assert svc.submit("hmax", x.float().numpy(), params={"h": 0.5}).result(
        ).device.type == "cpu"
    assert [type(e).__name__ for e in svc._engines.values()] == [
        "SlotEngine"]
    # the language-model path: its launcher and the model's initialiser
    from repro_torch.configs.registry import get_reduced
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import decode, model

    cfg = get_reduced("gemma-2b")
    argv = ["--reduced", "--batch", "1", "--prompt-len", "4", "--gen", "1"]
    for call in (lambda: lm_serve.main(argv),
                 lambda: lm_serve.load_model(cfg),
                 lambda: model.init_params(cfg, torch.Generator()),
                 lambda: decode.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the training path: its launcher, the trainer and the train step
    from repro_torch.launch import train as lm_train
    from repro_torch.optim import adamw
    from repro_torch.train import loop, steps

    targv = ["--reduced", "--steps", "1", "--seq-len", "8",
             "--global-batch", "1"]
    tcfg = loop.TrainerConfig(steps=1, seq_len=8, global_batch=1)
    for call in (lambda: lm_train.main(targv),
                 lambda: loop.Trainer(cfg, tcfg),
                 lambda: steps.build_train_step(cfg, adamw.AdamWConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    lm_train.main(targv + ["--device", "cpu"])
    trainer = loop.Trainer(cfg, tcfg, device="cpu")
    assert trainer.init_state()["params"].device.type == "cpu"
    lm_serve.main(argv + ["--device", "cpu"])
    lm = model.init_params(cfg, torch.Generator(), device="cpu")
    assert lm.device.type == "cpu"
    logits, cache = decode.prefill(lm, torch.zeros((1, 4), dtype=torch.long))
    assert logits.device.type == "cpu"
    assert decode.init_cache(cfg, 1, 8, "cpu")["layers"][0]["k"].device.type \
        == "cpu"


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; chip_smoke.py would run")
    procs = [subprocess.Popen([sys.executable, str(script)],
                              cwd=pathlib.Path(script).parent,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for script in (REPO / "chip_smoke.py",
                            shutil.copy(REPO / "chip_smoke.py", tmp_path))]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in out
