"""Target-hardware constants: one NVIDIA H100 SXM5 80GB HBM3 at its full
700 W power limit, in place of the reference's ``TPU_V5E``
(counterpart of ``repro.roofline.hw``).

Sources: the NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, dense
figures (no sparsity), and the NVIDIA DGX H100 datasheet for the node's
links.  A card set below 700 W runs slower under load, so a time priced
with these constants is a bound at 700 W.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops_bf16: float     # tensor-core dense bf16, FLOP/s per GPU
    peak_flops_f32: float      # float32 outside the tensor cores, FLOP/s
    hbm_bw: float              # bytes/s per GPU
    hbm_bytes: float
    nvlink_link_bw: float      # bytes/s per link, each way
    nvlink_links: int          # links per GPU
    inter_node_bw: float       # bytes/s per GPU between nodes, each way
    node_size: int             # GPUs a node, all on one NVLink switch fabric

    @property
    def nvlink_bw(self) -> float:
        """A GPU's NVLink bandwidth each way, all links together."""
        return self.nvlink_link_bw * self.nvlink_links


H100_SXM = HWSpec(
    name="h100-sxm5-80gb-hbm3-700w",
    peak_flops_bf16=989.4e12,  # H100 datasheet, SXM5: BF16 Tensor Core, dense
    peak_flops_f32=67e12,      # H100 datasheet, SXM5: FP32
    hbm_bw=3.35e12,            # H100 datasheet, SXM5: GPU memory bandwidth
    hbm_bytes=80e9,            # H100 datasheet, SXM5: GPU memory 80 GB
    nvlink_link_bw=25e9,       # H100 datasheet: NVLink 4, 18 links, 900 GB/s
    nvlink_links=18,           # both ways together, so 450e9 B/s each way
    inter_node_bw=50e9,        # DGX H100 datasheet: one 400 Gb/s ConnectX-7
                               # (NDR InfiniBand) port a GPU
    node_size=8,               # DGX H100 datasheet: 8 GPUs a node
)
