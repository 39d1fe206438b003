"""Process supervision (counterpart of ``analytics_zoo_tpu/cluster/``), the
serving half: ``FleetSupervisor`` spawns and drains server subprocesses to
follow the fleet router's scale signal. The training half (the pod
launcher, ``ElasticSupervisor`` and its lease stores) is ROADMAP Queue A
item 5d."""
from .supervisor import FleetSupervisor  # noqa: F401
