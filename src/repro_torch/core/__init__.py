"""Venice core: mesh topology, the rng stream and the Algorithm-1 oracle."""
from repro_torch.core.routing import ScoutResult, minimal_ports, scout_route_ref
from repro_torch.core.topology import MeshTopology, all_xy_paths, build_mesh

__all__ = ["MeshTopology", "ScoutResult", "all_xy_paths", "build_mesh",
           "minimal_ports", "scout_route_ref"]
