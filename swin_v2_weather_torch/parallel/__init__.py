from swin_v2_weather_torch.parallel.mesh import (
    batch_shard,
    init_distributed,
    make_mesh,
)
from swin_v2_weather_torch.parallel.spatial import roll_h_sharded, spatial_forward

__all__ = ["make_mesh", "batch_shard", "init_distributed", "roll_h_sharded", "spatial_forward"]
