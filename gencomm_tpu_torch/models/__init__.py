"""Models of the port. ``create_model`` builds one from a hypes dict, as
``gencomm_tpu/models/__init__.py:create_model`` does; of the JAX package's
families the heterogeneous GenComm model (``heter_baseline``), the HEAL
pyramid and multiscale models (``heter_pyramid``), the legacy SECOND
detectors (``ciassd.SecondModel``) and PIXOR (``encoders/pixor.py``) are
ported, and every other ``model.core_method`` raises
``NotImplementedError`` naming the ROADMAP item that ports it."""

from __future__ import annotations

# the JAX package's other model cores (matched as its create_model matches
# them) and the ROADMAP item of each
_OTHER_CORES = (
    (("ciassd", "second_ssfa", "second_ssfa_uncertainty"), 19),
    (("point_pillar_uncertainty", "point_pillar_baseline_multiscale",
      "fpvrcnn"), 19),
)


def create_model(hypes: dict, device=None):
    """The model named by ``model.core_method``, on ``device`` (default
    ``cuda``)."""
    core = hypes["model"]["core_method"].lower()
    for names, item in _OTHER_CORES:
        if core in names:
            raise NotImplementedError(
                f"model {core!r} is not ported yet (ROADMAP item {item})")
    if core in ("second", "second_intermediate"):
        from gencomm_tpu_torch.models.ciassd import build_second_model

        return build_second_model(hypes, device=device)
    if core == "heter_model_baseline_ms":
        from gencomm_tpu_torch.models.heter_pyramid import build_ms_model

        return build_ms_model(hypes, device=device)
    if "pyramid" in core:
        from gencomm_tpu_torch.models.heter_pyramid import build_pyramid_model

        return build_pyramid_model(hypes, device=device)
    if core.startswith("center_point"):
        raise NotImplementedError(
            f"model {core!r} is not ported yet (ROADMAP item 19)")
    if core.startswith("pixor"):
        from gencomm_tpu_torch.models.encoders.pixor import build_pixor_model

        return build_pixor_model(hypes, device=device)
    from gencomm_tpu_torch.models.heter_baseline import build_model

    return build_model(hypes, device=device)
