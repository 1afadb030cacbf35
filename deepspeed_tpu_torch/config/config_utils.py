"""Typed config base class.

Copy of ``deepspeed_tpu/config/config_utils.py`` (the reference's pydantic
base ``DeepSpeedConfigModel``, ``deepspeed/runtime/config_utils.py:17``):
JSON-compatible field names, ``"auto"`` sentinel support, and unknown-key
warnings rather than hard failures.
"""
from __future__ import annotations

from typing import Any, Dict

from pydantic import BaseModel, ConfigDict, model_validator

from deepspeed_tpu_torch.utils.logging import logger

AUTO = "auto"


class ConfigModel(BaseModel):
    """Base for all config subtrees.

    Unknown keys are allowed (collected into ``model_extra``) and warned
    about, matching the reference's tolerance for fields consumed by other
    layers.  The check runs as a model validator so it fires for nested
    subtrees validated by pydantic directly (a custom ``__init__`` would
    not).
    """

    model_config = ConfigDict(
        extra="allow",
        populate_by_name=True,
        validate_assignment=True,
        arbitrary_types_allowed=True,
        protected_namespaces=(),
    )

    @model_validator(mode="after")
    def _warn_unknown_keys(self):
        if self.model_extra:
            unknown = sorted(self.model_extra.keys())
            logger.warning(f"{self.__class__.__name__}: ignoring unknown "
                           f"config keys {unknown}")
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        return self.model_dump()


def get_scalar_param(d: Dict[str, Any], name: str, default: Any) -> Any:
    """Reference-style helper (``runtime/config.py`` get_* functions)."""
    return d.get(name, default)
