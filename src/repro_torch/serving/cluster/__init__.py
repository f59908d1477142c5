"""Multi-replica cluster serving: KV-aware routing + cross-replica KV
migration over the TransferEngine's peer channels, with runtime
autoscaling (drain-then-retire) and disaggregated prefill replicas."""
from repro_torch.serving.cluster.clock import ClusterClock
from repro_torch.serving.cluster.cluster import (Cluster, ClusterConfig,
                                           ClusterSimulator, ClusterStats,
                                           build_cluster,
                                           prefill_engine_config)
from repro_torch.serving.cluster.peer import Migration, PeerLink
from repro_torch.serving.cluster.router import ClusterRouter
from repro_torch.serving.cluster.scaling import ScalingConfig, ScalingPolicy

__all__ = ["Cluster", "ClusterClock", "ClusterConfig", "ClusterRouter",
           "ClusterSimulator", "ClusterStats", "Migration", "PeerLink",
           "ScalingConfig", "ScalingPolicy", "build_cluster",
           "prefill_engine_config"]
