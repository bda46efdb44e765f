"""Multi-chip scale-out via jax.sharding meshes (SURVEY.md §2.3).

The algorithm has no cross-frame dependencies, so the natural shardings are
- ``data``: independent frames/sequences across chips (the moral equivalent
  of the reference's GNU-parallel eval fan-out, eval/x-map-eval.sh:49,57);
- ``event``: events of one frame split across chips, with min/max
  collectives for the frame time window and a max-reduction of the packed
  disparity scatter (exactly associative, so results are bit-identical to
  the single-chip program).
"""

from xmaps.parallel.sharding import (  # noqa: F401
    make_mesh,
    make_sharded_pipeline,
    shard_batches,
)
