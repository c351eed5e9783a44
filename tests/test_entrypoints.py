"""Entry points (main.py, bench.py, chip_smoke.py) in fresh processes:
their import closure, the compile-cache location, the determinism flag,
and their refusal to measure without a GPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# packages the machine with the card is sure to have beside JAX
ALLOWED = "import jax, jax.numpy, numpy, scipy, optax, chex, einops"
BLOCKED = ("flax", "click", "msgpack", "xprof", "torch")

_TOPS = """
import sys
print(sorted({m.split(".")[0] for m in sys.modules}
             - set(sys.stdlib_module_names)))
"""

_BLOCKER = f"""
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


def _env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


def _python(code, *, cwd=ROOT, env=None, timeout=300):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=cwd,
                          env=env or _env())


def _tops(code):
    out = _python(code + "\njax.devices()\n" + _TOPS)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", ["main", "bench", "chip_smoke"])
def test_import_closure(module):
    """Importing the entry point (and every experiment config it reaches)
    needs nothing beyond JAX, numpy, scipy, optax, chex and einops: with
    flax/click/msgpack/xprof/torch blocked it imports, and it loads no
    third-party module that the allowed set does not load itself."""
    base = _tops(ALLOWED)
    ours = _tops(_BLOCKER + f"import {module}\n"
                 "import egc_tpu.exp.batched, egc_tpu.exp.fullgraph, "
                 "egc_tpu.exp.hetero, egc_tpu.parallel\nimport jax")
    assert ours - base - {module, "egc_tpu"} == set()


def test_compile_cache_default_dir():
    out = _python("""
from egc_tpu.utils.compile_cache import DEFAULT_DIR, enable_compile_cache
import jax
d = enable_compile_cache()
assert d == str(DEFAULT_DIR) == jax.config.jax_compilation_cache_dir, d
print(d)
""")
    assert out.returncode == 0, out.stderr[-2000:]
    path = Path(out.stdout.strip())
    assert path == ROOT / ".jax_cache"
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_compile_cache_honours_env(tmp_path):
    out = _python("""
from egc_tpu.utils.compile_cache import enable_compile_cache
import jax, os
d = enable_compile_cache()
assert d == os.environ["JAX_COMPILATION_CACHE_DIR"], d
assert jax.config.jax_compilation_cache_dir == d
print(d)
""", env=_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(tmp_path / "cc")


def test_enable_determinism_then_jitted_op_runs():
    """The flag parses at backend start-up and a jitted scatter-add runs
    under it, repeatably."""
    out = _python("""
import os
from egc_tpu.utils.debug import DETERMINISM_FLAG, enable_determinism
enable_determinism()
assert DETERMINISM_FLAG in os.environ["XLA_FLAGS"]
import jax, jax.numpy as jnp, numpy as np
x = jnp.asarray(np.random.default_rng(0).normal(size=(5000, 8)), jnp.float32)
ids = jnp.asarray(np.random.default_rng(1).integers(0, 50, 5000))
f = jax.jit(lambda x, i: jax.ops.segment_sum(x, i, num_segments=50))
a, b = np.asarray(f(x, ids)), np.asarray(f(x, ids))
assert np.array_equal(a, b)
print("ok", float(a.sum()))
""")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def _no_result(proc):
    return not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=_env())
    assert proc.returncode != 0
    assert _no_result(proc)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert _no_result(proc)


def test_bench_refuses_cpu():
    proc = subprocess.run([sys.executable, "bench.py", "--small"],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=_env())
    assert proc.returncode != 0
    assert _no_result(proc)
    assert "no GPU" in proc.stderr
