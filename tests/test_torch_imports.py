"""The PyTorch port stands alone: importing every one of its modules,
and ``chip_smoke.py``, loads neither JAX nor anything of the JAX package,
nor pandas (checked in a fresh interpreter, since this test process
imports all three)."""
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys, runpy
import lightgbm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # module body only: main() runs under __main__
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "lightgbm_tpu" or m.startswith("lightgbm_tpu.")
             or m == "pandas" or m.startswith("pandas."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split("\n") + [""] * (
        2 - len(out.stdout.strip().split("\n")))
    assert int(count) >= 21
    assert bad == "", "port pulled in: " + bad


def test_every_port_module_is_listed():
    import lightgbm_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   "lightgbm_tpu_torch.")}
    for mod in ("ops.forest", "ops.route", "ops.predict", "ops.binning",
                "ops.kernels", "ops.partition", "ops.histogram", "ops.split",
                "ops.commit", "ops.rank", "ops.chain", "ops.scan",
                "learner", "boosting", "basic", "convert", "engine",
                "callback", "metric", "prng", "fused",
                "serve.session", "serve.batcher", "serve.http",
                "online.registry", "online.buffer", "online.trainer",
                "shap", "sklearn", "plotting", "linear.pack", "tree",
                "dataset",
                "config", "objective", "obs", "utils.log",
                "io", "io_native", "cli", "__main__"):
        assert "lightgbm_tpu_torch." + mod in names, mod
