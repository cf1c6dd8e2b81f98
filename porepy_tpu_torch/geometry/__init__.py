from porepy_tpu_torch.geometry import (  # noqa: F401
    constrain_geometry,
    distances,
    half_space,
    intersections,
    map_geometry,
    point_in_polyhedron,
    sort_points,
)
