"""Installation script for shennong_tpu"""

import os
import re

from setuptools import setup, find_packages


def read_version():
    # parse __version__ without importing (the package needs its
    # dependencies at import time; a build environment may not)
    init = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        'shennong_tpu', '__init__.py')
    with open(init) as fp:
        return re.search(
            r"__version__\s*=\s*'([^']+)'", fp.read()).group(1)


setup(
    name='shennong-tpu',
    version=read_version(),
    description='A TPU-native speech features extraction toolbox',
    long_description=open('README.md').read(),
    long_description_content_type='text/markdown',
    license='GPL3',
    python_requires='>=3.10',
    packages=find_packages(exclude=['tests', 'tests.*']),
    install_requires=[
        'jax', 'numpy', 'scipy', 'pyyaml', 'h5py'],
    entry_points={'console_scripts': [
        'speech-features = shennong_tpu.cli:main',
        # the PyTorch port's CLI
        'speech-features-torch = shennong_tpu_torch.cli:main']},
    package_data={
        'shennong_tpu': ['share/crepe/*.npz', 'native/*.cpp'],
        # the PyTorch port builds its CUDA kernels from these
        'shennong_tpu_torch': [
            'csrc/*.cu', 'native/*.cpp', 'share/crepe/*.npz']},
    zip_safe=True,
)
