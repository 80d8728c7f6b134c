from collide.runtime.messaging import (Message, MessageBroker,
                                       MessageProducer, MessageConsumer,
                                       LocationDataProducer, TaskProducer,
                                       TaskResultProducer)
from collide.runtime.storage import (StorageInterface, InMemoryStorage,
                                     VehicleLocationStorage,
                                     CollisionRiskStorage,
                                     GridVehicleStorage, StorageFactory)
from collide.runtime.scheduler import Scheduler, SchedulerClient, TaskWorker
from collide.runtime.reliability import (HeartbeatMonitor, LeaderElection,
                                         ReplicationManager,
                                         FailoverManager,
                                         ThrottlingManager,
                                         ThrottlingPolicy,
                                         AdaptiveThrottling,
                                         StateTransferManager,
                                         RecoveryCoordinator)
