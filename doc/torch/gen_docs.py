#!/usr/bin/env python
"""Static documentation site of the PyTorch port, ``shennong_tpu_torch``.

Builds ``doc/torch/html/`` (or ``--output``) from the port's guides in
``doc/torch/*.md``, an index page from the port's section of
``README.md``, and one API page for every public module of
``shennong_tpu_torch``, found by walking the package. The docstring
renderer and the page templates are those of the JAX package's site
generator, ``doc/gen_docs.py``, taken by import (it imports neither
JAX nor the JAX package); nothing here imports either.

Usage: ``python doc/torch/gen_docs.py [--output DIR]``
"""

import argparse
import importlib.util
import os
import pkgutil
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, 'html')

sys.path.insert(0, REPO)

GUIDES = [
    # (source md in doc/torch/, output name, sidebar title)
    ('installation.md', 'installation.html', 'Installation'),
    ('migration.md', 'migration.html', 'Migrating from shennong_tpu'),
    ('features.md', 'features.html', 'Features and processors'),
    ('pipeline.md', 'pipeline.html', 'Extraction pipeline'),
    ('cli.md', 'cli.html', 'Command line interface'),
    ('performance.md', 'performance.html', 'Performance on the H100'),
    ('internals.md', 'internals.html', 'CUDA internals'),
]

#: sidebar groups of the API pages, by the module's first component
#: under the package (the root modules form the first group)
GROUP_TITLES = {
    '': 'Data model and pipeline',
    'processor': 'Processors',
    'postprocessor': 'Post-processors',
    'ops': 'Device operations and kernels',
    'parallel': 'Parallel execution',
    'models': 'Neural models',
    'eval': 'Evaluation',
    'native': 'Native runtime',
}


def renderer():
    """The JAX package's site generator, ``doc/gen_docs.py``, as a
    module: its docstring renderer and its templates."""
    spec = importlib.util.spec_from_file_location(
        'shennong_site_renderer', os.path.join(REPO, 'doc', 'gen_docs.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def public_modules():
    """Every public module of ``shennong_tpu_torch``, sorted: none with
    a component starting with '_' (or 'lib', the native libraries)."""
    import shennong_tpu_torch

    names = []
    for info in pkgutil.walk_packages(
            shennong_tpu_torch.__path__, prefix='shennong_tpu_torch.'):
        if any(part.startswith(('_', 'lib'))
               for part in info.name.split('.')):
            continue
        names.append(info.name)
    return sorted(names)


def api_groups(modules):
    """(title, [module names]) of the sidebar, in GROUP_TITLES' order."""
    groups = {key: [] for key in GROUP_TITLES}
    for name in modules:
        parts = name.split('.')
        key = parts[1] if len(parts) > 2 or parts[1] in groups else ''
        groups.setdefault(key, []).append(name)
    return [(GROUP_TITLES.get(key, key), names)
            for key, names in groups.items() if names]


def readme_port_section():
    """The port's section of README.md, its heading included."""
    with open(os.path.join(REPO, 'README.md')) as stream:
        text = stream.read()
    start = text.index('## PyTorch port')
    end = text.find('\n## ', start + 1)
    return text[start:] if end < 0 else text[start:end]


def build(out=OUT):
    """Write the site into ``out`` (emptied first). Returns the number
    of pages; raises when a module's page cannot be built."""
    import jinja2
    import markdown
    from pygments.formatters import HtmlFormatter

    site = renderer()
    page_tpl = jinja2.Environment(autoescape=False).from_string(
        site.PAGE_TEMPLATE.replace(
            '— shennong-tpu', '— shennong-tpu (PyTorch port)').replace(
                'TPU-native speech features extraction',
                'The PyTorch and CUDA port, on the H100'))
    mod_tpl = jinja2.Environment(autoescape=False).from_string(
        site.MODULE_TEMPLATE)
    pygments_css = HtmlFormatter(cssclass='codehilite').get_style_defs(
        '.codehilite')

    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)

    guides_nav = [('index.html', 'Overview')] + [
        (page, title) for _, page, title in GUIDES]
    api_nav, api_pages = [], []
    for group, names in api_groups(public_modules()):
        entries = []
        for name in names:
            href = name.replace('.', '_') + '.html'
            entries.append((href, name[len('shennong_tpu_torch.'):]))
            api_pages.append((href, name))
        api_nav.append((group, entries))

    def render(current, title, body):
        with open(os.path.join(out, current), 'w') as stream:
            stream.write(page_tpl.render(
                current=current, title=title, body=body, guides=guides_nav,
                api_nav=api_nav, pygments_css=pygments_css))

    md = markdown.Markdown(
        extensions=['fenced_code', 'codehilite', 'tables', 'toc'])
    for source, page, title in GUIDES:
        with open(os.path.join(HERE, source)) as stream:
            render(page, title, md.reset().convert(stream.read()))
    render('index.html', 'Overview',
           md.reset().convert(readme_port_section()))
    for href, name in api_pages:
        render(href, name, mod_tpl.render(mod=site.build_module_page(name)))
    return len(os.listdir(out))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--output', default=OUT,
                        help='the site directory [%(default)s]')
    args = parser.parse_args(argv)
    pages = build(args.output)
    print(f'doc site built at {args.output} ({pages} pages)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
