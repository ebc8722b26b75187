"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the port."""

import subprocess
import sys

from perfbench import guard
from perfbench.manifest import ROOT


def test_top_level_names_are_compared_whole():
    assert guard.loaded(modules=[
        'shennong_tpu_torch', 'shennong_tpu_torch.pipeline', 'jaxtyping',
        'flaxen', 'numpy']) == []
    assert guard.loaded(modules=[
        'shennong_tpu.ops.pitch', 'jax.numpy', 'jaxlib', 'flax.linen',
        'shennong_tpu_torch']) == ['flax', 'jax', 'jaxlib', 'shennong_tpu']


#: code that loads every harness module of the checkout
LOAD_HARNESSES = (
    'import os\n'
    'from perfbench.manifest import HERE, Manifest\n'
    'for name in os.listdir(os.path.join(HERE, "harness")):\n'
    '    if name.endswith(".py") and name != "__init__.py":\n'
    '        Manifest().harness(name[:-3])\n')


def modules_after(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\n'
         'print(sorted({m.split(".")[0] for m in sys.modules}))'],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
        env={'PYTHONPATH': ROOT, 'PATH': '/usr/bin:/bin'})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_its_reference_load_no_jax():
    """Every module of the harness, each pipeline's harness module
    among them."""
    loaded = modules_after(
        'import perfbench.bench, perfbench.check, perfbench.control, '
        'perfbench.tracing, perfbench.roofline\n'
        'import perfbench.reference.pipeline\n'
        + LOAD_HARNESSES + 'import shennong_tpu_torch.pipeline')
    assert not loaded & guard.FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    """Nor does a pipeline's harness module, which holds its
    reference."""
    loaded = modules_after(
        'import perfbench.reference.pipeline, perfbench.check, '
        'perfbench.corpus, perfbench.roofline\n' + LOAD_HARNESSES)
    assert 'shennong_tpu_torch' not in loaded
    assert not loaded & guard.FORBIDDEN
