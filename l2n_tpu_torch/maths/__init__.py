"""Math layer: host-side numpy matrix helpers (`linalg`) and torch SoA
helpers (`sampling`, `fastmath`)."""
