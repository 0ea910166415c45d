"""Loop closure: BoW place recognition, persistent maps, relocalization."""

from mvslam_tpu_torch.loopclosure.bow import BoWConfig, BoWDatabase, train_vocabulary
from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex
from mvslam_tpu_torch.loopclosure.persistent_map import (
    MapKeyframe,
    MapRelocalizer,
    PersistentMapSnapshot,
    load_map_snapshot,
    save_map_snapshot,
)
from mvslam_tpu_torch.loopclosure.map_builder import MapBuilderConfig, MapSnapshotBuilder

__all__ = [
    "BoWConfig",
    "BoWDatabase",
    "DeviceBoWIndex",
    "train_vocabulary",
    "MapKeyframe",
    "MapRelocalizer",
    "PersistentMapSnapshot",
    "load_map_snapshot",
    "save_map_snapshot",
    "MapBuilderConfig",
    "MapSnapshotBuilder",
]
