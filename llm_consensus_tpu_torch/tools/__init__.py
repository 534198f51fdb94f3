"""Standalone maintenance tools shipped beside the port's CLI: the
reference's second binary, ``cmd/model-registry-sync``, as a runnable module
(``python -m llm_consensus_tpu_torch.tools.registry_sync``) and as the
``model-registry-sync-torch`` console script.
"""
