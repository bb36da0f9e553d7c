"""The paper's comparison baselines (Sec. VII-A), numpy on the host, the
same algorithms as ``repro.baselines``:

* sequential_ml — an hMETIS-style sequential multi-level partitioner
  adapted to the size + distinct-inbound constraints ([4, 13] in the paper)
* overlap      — greedy incidence-overlap SNN mapper ([4])
* onepass      — single-pass constraint-driven filler ([5])

They stay sequential host code on purpose: they are what the paper's
speed-up is measured against.
"""
from repro_torch.baselines.onepass import onepass_partition  # noqa: F401
from repro_torch.baselines.overlap import overlap_partition  # noqa: F401
from repro_torch.baselines.sequential_ml import (  # noqa: F401
    sequential_multilevel)
