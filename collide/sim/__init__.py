from collide.sim.integrator import integrate
from collide.sim.generator import generate_fleet, default_cities
from collide.sim.traffic import (TrafficMap, RoadSegment, City,
                                 VehicleSimulator, scene_sink)
from collide.sim.scenario import (RoadTable, CityTable, ScenarioState,
                                  build_road_table, build_city_table,
                                  init_scenario, scenario_integrate,
                                  scenario_from_simulator,
                                  make_scenario_step)
