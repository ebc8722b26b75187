"""The port's documentation site builds and covers every public module.

Counterpart of tests/test_docs.py for ``doc/torch/gen_docs.py``: the
site builds into a temporary directory, the seven guides are there and
not trivial, every public module of ``shennong_tpu_torch`` has its API
page, a processor's page renders its class and a numpy ``Parameters``
block, the index is the README's section on the port, and the
performance guide quotes the card's numbers with its name and power
limit, and no TPU's.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import shennong_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(REPO, 'doc', 'torch')
GUIDES = ('installation', 'migration', 'features', 'pipeline', 'cli',
          'performance', 'internals')


@pytest.fixture(scope='module')
def site(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('site') / 'html')
    proc = subprocess.run(
        [sys.executable, os.path.join(DOC, 'gen_docs.py'), '--output', out],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return out


def public_modules():
    names = []
    for info in pkgutil.walk_packages(
            shennong_tpu_torch.__path__, prefix='shennong_tpu_torch.'):
        if not any(part.startswith(('_', 'lib'))
                   for part in info.name.split('.')):
            names.append(info.name)
    return names


def test_site_builds(site):
    pages = os.listdir(site)
    assert 'index.html' in pages
    assert len(pages) == len(GUIDES) + 1 + len(public_modules())


@pytest.mark.parametrize('guide', GUIDES)
def test_guides_present(site, guide):
    with open(os.path.join(DOC, guide + '.md')) as stream:
        assert len(stream.read()) > 2500, guide
    path = os.path.join(site, guide + '.html')
    assert os.path.getsize(path) > 8000, guide


def test_every_public_module_documented(site):
    modules = public_modules()
    assert len(modules) > 50
    for name in ('shennong_tpu_torch.ops.cuda_viterbi',
                 'shennong_tpu_torch.parallel.distributed',
                 'shennong_tpu_torch.eval.abx'):
        assert name in modules
    missing = [name for name in modules if not os.path.isfile(
        os.path.join(site, name.replace('.', '_') + '.html'))]
    assert not missing, f'undocumented modules: {missing}'


def test_api_page_has_classes_and_parameters(site):
    with open(os.path.join(
            site, 'shennong_tpu_torch_processor_mfcc.html')) as stream:
        html = stream.read()
    assert 'MfccProcessor' in html
    assert '<span class="kind">class</span>' in html
    assert '<dl class="params">' in html
    with open(os.path.join(
            site, 'shennong_tpu_torch_parallel_fused.html')) as stream:
        html = stream.read()
    assert 'pack_payload' in html and 'mfcc_pitch_pipeline' in html


def test_index_is_the_readme_port_section(site):
    with open(os.path.join(site, 'index.html')) as stream:
        html = stream.read()
    assert 'PyTorch port' in html
    assert 'examples/torch' in html
    assert 'Numerical parity' not in html  # a section of the JAX package


def test_cli_page_covers_subcommands(site):
    with open(os.path.join(site, 'cli.html')) as stream:
        html = stream.read()
    for command in ('config', 'extract', 'warmup', 'convert-crepe',
                    '--device'):
        assert command in html


def test_performance_guide_is_the_cards():
    with open(os.path.join(DOC, 'performance.md')) as stream:
        text = stream.read()
    assert 'H100 80GB HBM3' in text and '700.00 W' in text
    assert not re.search(r'\bv[245][ep]?\b|TPU v|\bchip\b', text)
