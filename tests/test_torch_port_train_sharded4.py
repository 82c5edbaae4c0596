"""The port's data-parallel train step on 4 CPU ranks against the JAX
package's ``make_sharded_train_step`` on a mesh of 4 virtual devices; the
setting, the bars and the mesh of 2 are in
tests/test_torch_port_train_sharded.py (one compiled JAX step per file)."""

from __future__ import annotations

import pytest

from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train_sharded import (check_against_reference,
                                                 jax_sharded_reference, seeded_variables)


@pytest.fixture(scope="module")
def variables(tmp_path_factory):
    return seeded_variables(tmp_path_factory.mktemp("init"))


def test_sharded_step_matches_the_references_on_a_mesh_of_4(variables):
    check_against_reference(variables, jax_sharded_reference(variables, 4), 4)
