"""Fleet serving: durable online state and multi-replica model
distribution (PyTorch port of ``lightgbm_tpu/fleet``).

- :class:`~lightgbm_tpu_torch.fleet.store.FleetStore`: a durable JSONL
  store (one-write appends, corrupt-line skip) holding the ingest stream,
  the promotion-gate history and version-tokened whole-model artifacts,
  with a trainer lease fenced by epoch, log compaction that replays bit
  for bit (optionally into a snapshot blob), sha256-checked artifacts
  and orphan reaping. A restarted trainer replays it and resumes its
  shadow window instead of cold-starting. The on-disk format is the JAX
  package's, byte for byte: either package reads the other's directory.
- :class:`~lightgbm_tpu_torch.fleet.replica.ReplicaWatcher`: N serving
  replicas watch the store and hot-swap through ``GBDT.adopt``, so every
  replica serves whole published models only (one version bump per
  applied publish).
- :class:`~lightgbm_tpu_torch.fleet.transport.RemoteStore`: replicas off
  the trainer's filesystem (the publish feed and artifacts over stdlib
  HTTP, with retries, capped jittered backoff and checksum checks).
- :mod:`lightgbm_tpu_torch.fleet.control`: the remote write surface
  (:class:`RemoteWriteStore`), multi-endpoint failover for replicas
  (:class:`EndpointSelector`, :class:`MultiEndpointStore`) and ingest
  forwarding to the lease holder (:class:`IngestForwarder`).
- :mod:`lightgbm_tpu_torch.fleet.chaos`: the seeded fault-injection
  switchboard the failover tests drive all of it with.

Everything here is host Python; what runs on the card is the serving
booster's predict (the forest kernel or the raw-threshold walk) and the
online trainer's candidates.
"""
from .control import (EndpointSelector, IngestForwarder,
                      MultiEndpointStore, RemoteWriteStore)
from .replica import ReplicaWatcher, bootstrap_model
from .store import (CorruptArtifactError, FleetStore, StaleLeaseError)
from .transport import RemoteStore, TransportError

__all__ = ["FleetStore", "ReplicaWatcher", "RemoteStore",
           "RemoteWriteStore", "MultiEndpointStore", "EndpointSelector",
           "IngestForwarder", "bootstrap_model", "StaleLeaseError",
           "CorruptArtifactError", "TransportError"]
