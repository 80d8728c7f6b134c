from collide.api.scene import Scene
from collide.api.sharded_scene import ShardedScene
