from collide.detect.pipeline import PairRisks, detect_pairs
from collide.detect.predict import (TrajectoryHistory, empty_history,
                                    update_history, classify_trajectories,
                                    needs_fallback, predict_collisions)
