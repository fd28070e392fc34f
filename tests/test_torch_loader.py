"""ArcFlow adapter files cross between the packages: a file JAX's
``save_adapter_state`` writes loads in the port (``pipelines/loader.py``)
with the same weights and ``policy_config``, and the reverse, for both
families; keys no map takes raise in the port as in JAX.

The adapters are the ArcFlow surface (heads, ``norm_out``, LoRA rank 2) of
random tiny JAX trees, as in ``test_torch_convert_diffusers.py``; values
are compared bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from arcflow_tpu.models import ARCFLUX_ADAPTER_KEYS, ARCQWEN_ADAPTER_KEYS
from arcflow_tpu.pipelines import load_adapter_state as j_load
from arcflow_tpu.pipelines import save_adapter_state as j_save
from arcflow_tpu.utils.pytree import flatten, partition_params
from arcflow_tpu_torch.pipelines import (jax_params_to_torch,
                                         load_adapter_state,
                                         save_adapter_state)
from test_torch_convert_diffusers import assert_same, trees  # noqa: F401

KEYS = dict(flux=ARCFLUX_ADAPTER_KEYS, qwen=ARCQWEN_ADAPTER_KEYS)
POLICY = dict(nfe=2, timestep_ratio=0.5, temperature=0.7,
              name='arcflow-k4', sizes=[1, 2])


def _adapter(trees, family):
    adapter, _ = partition_params(trees[family], KEYS[family])
    assert any(k.endswith('.lora_a') for k in flatten(adapter))
    return jax.device_get(adapter)


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_jax_file_loads_in_the_port(trees, family, tmp_path):  # noqa: F811
    adapter = _adapter(trees, family)
    path = str(tmp_path / 'jax.safetensors')
    j_save(path, adapter, policy_config=POLICY, family=family)
    state, policy = load_adapter_state(path, family=family)
    assert policy == POLICY
    assert_same(state, jax_params_to_torch(adapter))


@pytest.mark.parametrize('family', ['flux', 'qwen'])
def test_port_file_loads_in_jax(trees, family, tmp_path):  # noqa: F811
    adapter = _adapter(trees, family)
    path = str(tmp_path / 'port.safetensors')
    save_adapter_state(path, jax_params_to_torch(adapter),
                       policy_config=POLICY, family=family)
    tree, policy = j_load(path, family=family)
    assert policy == POLICY
    assert_same(jax_params_to_torch(tree), jax_params_to_torch(adapter))
    # and back through the port, without a policy
    save_adapter_state(path, jax_params_to_torch(adapter), family=family)
    state, policy = load_adapter_state(path, family=family)
    assert policy is None
    assert_same(state, jax_params_to_torch(adapter))


def test_unconvertible_keys_raise_in_both(trees, tmp_path):  # noqa: F811
    from safetensors.numpy import save_file
    path = str(tmp_path / 'bad.safetensors')
    save_file({'proj_out_means.bias': np.zeros(64, np.float32),
               'some.other.layer.weight': np.zeros((2, 2), np.float32)},
              path)
    with pytest.raises(ValueError, match='1 unconvertible keys'):
        j_load(path)
    with pytest.raises(ValueError, match='1 unconvertible keys'):
        load_adapter_state(path)
    with pytest.raises(NotImplementedError, match='queue A item 7'):
        load_adapter_state('huggingface://org/repo/adapter.safetensors')


def test_bf16_adapter_round_trips_in_the_port(tmp_path):
    """The port keeps a bf16 leaf bf16 (JAX's numpy reader has no bf16)."""
    state = {'norm_out.modulation.weight':
             torch.randn(8, 4, generator=torch.Generator().manual_seed(0)
                         ).to(torch.bfloat16)}
    path = str(tmp_path / 'bf16.safetensors')
    save_adapter_state(path, state)
    got, _ = load_adapter_state(path)
    assert_same(got, state)
