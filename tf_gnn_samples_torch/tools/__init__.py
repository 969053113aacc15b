"""The port's profiling harnesses (counterparts of tools/ at the repository
root): `film_fwd_ab` times the K16 variants of the FiLM kernels K1 and K2,
`rowgather_prof` the K16 row gathers beside torch.index_select. Each runs
on the card by default, or with `--device cpu` on the kernels' plain
versions. `earlier_designs` launches the earlier designs of K3, K4, K9
and K12a, the baselines that chip_smoke.py times their redesigns
against:

    python -m tf_gnn_samples_torch.tools.film_fwd_ab [E] [D]
    python -m tf_gnn_samples_torch.tools.rowgather_prof [E] [D] [ROWS]
"""
