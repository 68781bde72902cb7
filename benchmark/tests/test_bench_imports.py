"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names."""

import subprocess
import sys

from benchmark import run
from benchmark.harness import spec

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.harness import compare, drivers, models, runner, spec, trace
from benchmark.harness import traffic, work
from benchmark.reference import decoder, numerics, upscale
import hdrvae_torch.api.vae, hdrvae_torch.core.config
import hdrvae_torch.decode.pipeline, hdrvae_torch.models.params
import hdrvae_torch.models.zoo, hdrvae_torch.serve.engine
import hdrvae_torch.upscale.pipeline
b = spec.load_benchmark()
for m in b["end_to_end"] + b["per_layer"]:
    spec.metric_reader(m["name"])
print(",".join(run.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_names_compare_whole():
    assert run.forbidden_modules(["hdrvae_torch", "hdrvae_torch.kernels",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["hdrvae.core", "jax.numpy", "jaxlib",
                                  "flax.linen", "hdrvae_torch"]) == \
        ["flax", "hdrvae", "jax", "jaxlib"]
