"""The paper's cloud resource manager: profiles, formulation, MC-VBP solvers,
allocation plans and the fleet simulator."""
