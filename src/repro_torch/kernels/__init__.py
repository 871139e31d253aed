"""Hand-written CUDA kernels, their plain PyTorch versions and dispatch."""


def on_card(device) -> bool:
    """Whether work on ``device`` goes to the hand-written kernels (a CUDA
    device) rather than to their plain versions.  Every dispatch site of
    the port asks this one predicate (``ops``, each wrapper through
    ``_build.on_card``, ``models.model.logits_from_hidden``), so a stand-in
    for the card (``launch.dryrun.CardStandIn``) replaces it alone."""
    return device.type == "cuda"
