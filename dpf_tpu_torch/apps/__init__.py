"""Protocol applications on the port's FSS stack.

The port's counterpart of ``dpf_tpu/apps``: the layer that turns the
primitives (batched Gen on the card, grouped pointwise evaluation, packed
wire words) into whole server-side protocol workloads:

  heavy_hitters  prefix-tree heavy hitters: the dealer's one batched Gen of
                 every client's level keys, then a levelwise descent, one
                 walk launch per stateless round or one frontier extension
                 per level of the incremental descent (hh_state), with the
                 public counts reconstructed on the card.
  aggregation    secure aggregation: streamed XOR / additive-mod-2^32 folds
                 of client share vectors in chunks, the carry on the card.

  pir_store      named PIR databases resident on the card, with their scan
                 counters (``core/plans.run_pir`` scans them).

Their dispatches go through the plan cache (``core/plans.py``).
"""

from . import aggregation, heavy_hitters, pir_store

__all__ = ["aggregation", "heavy_hitters", "pir_store"]
