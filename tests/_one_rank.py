"""A one-rank gloo process group in the test's own process, for the
port's entry points that take a mesh plan (no spawn)."""
import contextlib
import os

import torch.distributed as dist

from repro_torch.dist.sharding import make_mesh


@contextlib.contextmanager
def one_rank_plan(tmp_path, **flags):
    """The plan of a (1, 1) mesh on the CPU with ``flags`` (``lm_rules``'s),
    over a one-rank gloo group made here (a ``file://`` rendezvous under
    ``tmp_path``) and destroyed after."""
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method="file://"
                            + os.path.join(str(tmp_path), "one_rank_pg"))
    try:
        yield make_mesh(1, 1, "cpu", **flags)
    finally:
        dist.destroy_process_group()
