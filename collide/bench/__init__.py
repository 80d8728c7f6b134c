from collide.bench.harness import PerformanceTester, PerformanceMetrics
from collide.bench.load_generator import (LoadGenerator, LoadTestResult,
                                          FailureInjector,
                                          PerformanceAnalyzer)
from collide.bench.monitor import PerformanceMonitor
