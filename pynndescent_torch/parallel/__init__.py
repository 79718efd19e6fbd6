from pynndescent_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_mesh_2d,
    sharded_nn_descent,
    sharded_search,
)
