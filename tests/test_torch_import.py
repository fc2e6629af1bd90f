"""The PyTorch port imports without JAX and without the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ["qmg_tpu_torch", "qmg_tpu_torch.lattice", "qmg_tpu_torch.rng",
           "qmg_tpu_torch.u1", "qmg_tpu_torch.cshift",
           "qmg_tpu_torch.linalg", "qmg_tpu_torch.stencil",
           "qmg_tpu_torch.operators", "qmg_tpu_torch.operators.wilson",
           "qmg_tpu_torch.operators.coarse",
           "qmg_tpu_torch.operators.laplace",
           "qmg_tpu_torch.operators.staggered",
           "qmg_tpu_torch.operators.dwf", "qmg_tpu_torch.goldstone",
           "qmg_tpu_torch.checkpoint", "qmg_tpu_torch.cuda_build",
           "qmg_tpu_torch.wilson_kernel", "qmg_tpu_torch.dslash_kernel",
           "qmg_tpu_torch.dslash", "qmg_tpu_torch.solvers",
           "qmg_tpu_torch.transfer", "qmg_tpu_torch.multigrid",
           "qmg_tpu_torch.eig", "qmg_tpu_torch.stateful",
           "qmg_tpu_torch.setup", "qmg_tpu_torch.solve",
           "qmg_tpu_torch.kcycle", "qmg_tpu_torch.parallel",
           "qmg_tpu_torch.shard_dslash", "qmg_tpu_torch.bench",
           "qmg_tpu_torch.attrib"]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith(('jax.', 'jaxlib',\n"
        "                                            'qmg_tpu.'))\n"
        "             or k == 'qmg_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
