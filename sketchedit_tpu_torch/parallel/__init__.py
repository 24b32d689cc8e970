"""Multi-device execution (counterpart of ``sketchedit_tpu/parallel``):
batch replicas for the edit pipeline (``mesh``), the contextual attention's
query-patch axis split over devices (``sharded_attention``), and
data-parallel training across processes (``distributed``)."""
