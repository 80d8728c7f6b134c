from collide.shard.step import (make_mesh, make_sharded_step,
                                make_sharded_scenario_step,
                                make_sharded_ingest,
                                distribute_state, collect_state,
                                shard_slots, equal_boundaries,
                                check_boundaries)
from collide.shard.halo import migrate, halo_exchange, slab_bounds
from collide.shard.balance import LoadBalancer, shard_occupancy, imbalance, quantile_boundaries
from collide.shard.predict import (make_sharded_predict,
                                   distribute_history, predict_reach)
