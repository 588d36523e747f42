"""The paper's own experimental model family (scaled): All-CNN-style
convnet (Springenberg et al., 2014) used for the Table 1 / Table 2
analogues on synthetic classification streams, plus the MLP used by the
Fig. 1 overlap experiment.  Not a ModelConfig — these are built directly
by models/convnet.py; this module records the paper-faithful
hyper-parameters (§4.3, §5).
"""
PAPER_HP = dict(
    n_replicas=3,       # paper's main setting (WRN-28-10, All-CNN)
    L=25,               # §3.1
    alpha=0.75,         # §3.1
    gamma0=1e2, rho0=1.0,
    gamma_min=1.0, rho_min=0.1,
    momentum=0.9,       # Nesterov, Remark 2
    lr=0.1,             # dropped 5-10x on plateau (§3.1)
    weight_decay=1e-3,  # All-CNN setting (§5)
    dropout=0.5,        # recorded; not used by the synthetic analogue
)
