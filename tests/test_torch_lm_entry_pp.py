"""The LM entry script's pipelines over gloo ranks (``python -m
tpu_sandbox_torch.lm_train --force-cpu --parallelism pp|pp_sp|3d``), the
four of tests/test_lm_train.py:40-62, each rank 0 printing the JAX
script's lines and the losses of the single-device run of the same
flags. Moved out of tests/test_torch_lm_train.py so that a worker of its
own runs them; the four entry runs start a few at a time while the
references train here."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_lm_entry import log_losses, run_entries
from tpu_sandbox_torch import lm_train
from torch_threads import one_torch_thread  # noqa: F401

#: tests/test_lm_train.py's small LM (its _args base, fp32), 8 steps: the
#: loss falls in 4 on every pipeline
PP_STEPS, PP_EVERY = 8, 4
PP_BASE = ["--force-cpu", "--steps", str(PP_STEPS), "--batch", "4",
           "--seq-len", "32", "--vocab", "16", "--d-model", "16",
           "--n-heads", "2", "--n-layers", "2", "--d-ff", "32", "--lr",
           "1e-2", "--microbatches", "2", "--log-every", str(PP_EVERY)]
#: the pipelines of tests/test_lm_train.py:40-62
PP_RUNS = {
    "pp": ["--parallelism", "pp", "--devices", "4", "--n-layers", "4"],
    "pp_circular": ["--parallelism", "pp", "--devices", "4", "--n-layers",
                    "8", "--microbatches", "4", "--circular-chunks", "2"],
    "pp_sp": ["--parallelism", "pp_sp", "--devices", "4"],
    "3d": ["--parallelism", "3d", "--devices", "8", "--n-layers", "2",
           "--batch", "4"],
}


@pytest.fixture(scope="module")
def entries():
    """The four entry runs, started in the background: a future of
    ``run_entries``."""
    with ThreadPoolExecutor(1) as pool:
        runs = pool.submit(run_entries, {name: PP_BASE + flags
                                         for name, flags in PP_RUNS.items()})
        yield runs             # the references train here meanwhile


@pytest.mark.parametrize("run", sorted(PP_RUNS))
def test_entry_script_trains_the_pipelines_on_gloo_ranks(entries, run):
    """``--force-cpu`` ranks (4, or 8 for 3d), rank 0 printing the JAX
    script's lines; the loss falls, and each printed loss is the one the
    single-device run of the same flags prints (the pipelines compute its
    function: the mean over microbatch means, the gradients summed over
    'pipe' where a stage owns them)."""
    flags = PP_BASE + PP_RUNS[run]
    proc = entries.result()[run]
    assert proc.returncode == 0, proc.stderr
    parallelism = flags[flags.index("--parallelism") + 1]
    losses = log_losses(proc.stdout, parallelism, PP_STEPS, PP_EVERY)
    assert losses[-1] < losses[0]
    dp = lm_train.build_parser().parse_args(flags)
    dp.parallelism, dp.devices = "dp", 1
    np.testing.assert_allclose(losses, lm_train.train(dp).losses, rtol=0,
                               atol=2e-4)
