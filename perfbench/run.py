"""The benchmark's command: ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout
(see :mod:`perfbench.bench`)."""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

#: host threads of each library pool (OpenMP, which PyTorch's CPU
#: operations use, and the BLAS under numpy), fixed before either is
#: imported: by default each takes every core beside the port's own
#: threads (pass 2, decode, dispatch); at one thread each the corpus
#: ran about 10% faster and steadier on an 8-core H100 host
HOST_THREADS = 1
for _variable in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS',
                  'MKL_NUM_THREADS'):
    os.environ[_variable] = str(HOST_THREADS)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.bench import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], START))
