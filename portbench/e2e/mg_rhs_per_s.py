"""``rhs_per_s`` of the MG cells: MG setups done inside the window count
in its time."""

from portbench.e2e.rhs_per_s import read  # noqa: F401
