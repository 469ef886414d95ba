"""The paper's own evaluation model: GraphChallenge sparse DNN (§VI-A).

Not one of the language models: this config names the net the FSI path
runs (``repro_torch.data.graphchallenge.make_sparse_dnn`` builds it) and
the BSR kernel path.  N is selectable at run time.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="sparse-dnn-graphchallenge",
    family="dense",
    n_layers=120,
    d_model=1024,           # default N; benchmarks sweep {1024..65536}
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=0,
    source="GraphChallenge [Kepner et al., HPEC'19]",
)
