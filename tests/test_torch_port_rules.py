"""Rules the PyTorch port keeps.

* ``ray_tpu_torch/`` and ``chip_smoke.py`` import nothing of JAX and
  nothing of the JAX package (they keep their own copies instead).
* The port never falls back quietly from the card to the CPU or from a
  kernel to its plain version: entry points raise without a card unless
  given ``device="cpu"``, and the kernel and model modules catch nothing.
"""

import ast
import asyncio
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "ray_tpu"}


def _port_files():
    # The kernel tests run on the card, which has no JAX, so they too.
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_flash_kernel.py",
        ROOT / "tests" / "test_torch_flash_bwd_kernel.py",
        ROOT / "tests" / "test_torch_splash_kernel.py",
        ROOT / "tests" / "test_torch_llama_kernel.py"]
    assert len(files) > 10
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args and
              isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in _port_files()}
    assert not {k: v for k, v in bad.items() if v}, bad


def _handlers(path):
    """(line, the source of the caught type or None for a bare except) of
    each except handler in a file."""
    tree = ast.parse(path.read_text(), str(path))
    return [(n.lineno, ast.unparse(n.type) if n.type is not None else None)
            for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]


# The handlers autotune/ may hold: the sweep skips a candidate that runs
# out of device memory (recorded in its record's meta), and the cache
# reads an unreadable file or a torn line as missing.  None of them is
# around a kernel launch.
AUTOTUNE_HANDLERS = {"search.py": ["torch.cuda.OutOfMemoryError"],
                     "cache.py": ["OSError", "ValueError"]}


def test_kernel_and_model_modules_catch_nothing():
    """A try/except around a launch is how a quiet fallback would look."""
    offenders = []
    for sub in ("ops", "models"):
        for path in sorted((PORT / sub).rglob("*.py")):
            offenders += [f"{path.name}:{line}"
                          for line, _ in _handlers(path)]
    assert not offenders, offenders


def test_autotune_catches_only_oom_and_unreadable_cache_lines():
    """No quiet fallback in the dispatcher or the sweep: the only handlers
    are the sweep's one out-of-memory skip and the cache's file reads."""
    found = {}
    for path in sorted((PORT / "autotune").rglob("*.py")):
        caught = [t for _, t in _handlers(path)]
        if caught:
            found[path.name] = sorted(caught)
    assert found == AUTOTUNE_HANDLERS, found


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import (GPTConfig, LlamaConfig, gpt_init,
                                      init_paged_cache, llama_init,
                                      llama_init_paged_cache, mlp_init,
                                      params_from_jax)
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = GPTConfig.tiny(vocab=32, seq=16)
    lcfg = LlamaConfig.tiny(vocab=32, seq=16)
    tree = {"wte": np.zeros((32, 64), np.float32)}
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: gpt_init(0, cfg),
                 lambda: llama_init(0, lcfg),
                 lambda: mlp_init(0, [4, 8, 2]),
                 lambda: params_from_jax(tree, cfg),
                 lambda: init_paged_cache(cfg, 4, 8),
                 lambda: llama_init_paged_cache(lcfg, 4, 8),
                 lambda: InferenceEngine(EngineConfig(model_config=cfg,
                                                      max_prompt_len=8,
                                                      max_new_tokens=8)),
                 lambda: InferenceEngine(EngineConfig(model="llama",
                                                      max_prompt_len=8,
                                                      max_new_tokens=8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import GPTConfig, gpt_forward, gpt_init
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    assert resolve_device("cpu") == torch.device("cpu")
    cfg = GPTConfig.tiny(vocab=32, seq=16)
    params = gpt_init(0, cfg, device="cpu")
    logits = gpt_forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)
    assert logits.shape == (1, 4, 32) and torch.isfinite(logits).all()

    async def run():
        eng = InferenceEngine(EngineConfig(model_config=cfg, max_prompt_len=8,
                                           max_new_tokens=4, device="cpu"))
        toks = [t async for t in eng.generate([1, 2, 3], 4)]
        eng.close()
        return toks

    assert len(asyncio.run(run())) == 4
