"""Every JAX example has a counterpart in ``examples/torch/``, and the
loader the other ``tests/test_torch_examples_*.py`` files use:
``load('serve_throughput')`` is the port's
``examples/torch/serve_throughput.py``, ``load('serve_throughput',
jax=True)`` the JAX package's ``examples/serve_throughput.py``, each
imported once under a module name of its own."""

import glob
import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port's examples, one for each of the JAX package's
SCRIPTS = ('extract_corpus', 'serve_throughput', 'long_audio',
           'sustained_scale', 'vtln_warps', 'features_abx', 'training_bench',
           'multihost_cmvn', 'abx_benchmark', 'abx_score', 'pitch_comparison',
           'plot_features', 'serializer_bench')

_LOADED = {}


def load(name, jax=False):
    """The example ``name`` of the port, or of the JAX package with
    ``jax``, imported once under a module name of its own."""
    key = ('jax_example_' if jax else 'torch_example_') + name
    if key not in _LOADED:
        path = os.path.join(REPO, 'examples', *(() if jax else ('torch',)),
                            name + '.py')
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[key] = module
    return _LOADED[key]


def test_every_jax_example_has_a_counterpart():
    """The JAX package's examples are :data:`SCRIPTS`, each has a script
    of the same name in ``examples/torch/`` with a ``main(argv=None)``,
    and the port's README table lists each."""
    jax_scripts = sorted(
        os.path.basename(path)[:-3]
        for path in glob.glob(os.path.join(REPO, 'examples', '*.py')))
    assert jax_scripts == sorted(SCRIPTS)
    with open(os.path.join(REPO, 'examples', 'torch', 'README.md')) as stream:
        readme = stream.read()
    for name in SCRIPTS:
        assert os.path.isfile(
            os.path.join(REPO, 'examples', 'torch', name + '.py')), name
        assert f'`{name}.py`' in readme, name
        assert 'argv' in load(name).main.__code__.co_varnames, name
