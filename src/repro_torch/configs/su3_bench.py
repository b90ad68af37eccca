"""The paper's own workload: SU3_Bench lattice configs (core.su3.engine)."""
from repro_torch.core.su3.engine import EngineConfig
from repro_torch.core.su3.layouts import Layout

# Paper's headline configuration: L=32 (1,048,576 sites), fp32 (576 MiB A+C).
PAPER_L32 = EngineConfig(L=32, dtype="float32", layout=Layout.SOA, variant="cuda",
                         iterations=100, warmups=1)
# PIUMA-section configuration: L=16, 4 iterations (paper §5).
PIUMA_L16 = EngineConfig(L=16, dtype="float32", layout=Layout.SOA, variant="cuda",
                         iterations=4, warmups=0)
# CPU-friendly smoke configuration (run with device="cpu").
SMOKE_L8 = EngineConfig(L=8, dtype="float32", layout=Layout.SOA, variant="cuda",
                        iterations=3, warmups=1, tile=128)
