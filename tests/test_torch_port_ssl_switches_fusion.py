"""The port's SSL iteration without the fusion matching
(``confthr_no_fusion``, ``confthr_2d_only``) against the JAX package's
branch losses: two of the four ConfThr settings of
``test_torch_port_ssl_switches.py``, whose set-up and check they run, in
a file of their own so that another worker takes them.
"""
import pytest

from test_torch_port_ssl_switches import run_switch, setup  # noqa: F401
from torch_port_ssl_fixture import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["confthr_2d_only", "confthr_no_fusion"])
def test_iteration_under_switches(setup, name):
    run_switch(setup, name)
