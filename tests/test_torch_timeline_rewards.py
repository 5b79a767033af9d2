"""The timeline operator and the reward options against the JAX package.

Every case of ``tests/test_offline_e2e.py``'s timeline and reward tests
(``test_timeline_transform_contract``, ``test_multi_step_timeline``,
``test_reward_options_shaping``, ``test_partitioned_timeline_matches_single_shard``)
runs on both packages from the same numpy-made tables; the outputs must be
equal DataFrames (the same pandas code on the same rows: no tolerance),
and the port's must also meet the JAX test's own assertions.
"""

import numpy as np
import pandas as pd
import pytest

from reagent_tpu.data import reward_options as jax_reward_options
from reagent_tpu.data import timeline as jax_timeline
from reagent_tpu_torch.data import reward_options, timeline
from test_offline_e2e import _toy_logged_df


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_timeline_transform_matches_jax(shuffle):
    df = _toy_logged_df()
    out = timeline.timeline_transform(df, shuffle=shuffle, seed=3)
    pd.testing.assert_frame_equal(out, jax_timeline.timeline_transform(df, shuffle=shuffle, seed=3))
    assert len(out) == 12
    ep0 = out[out.mdp_id == "0"].sort_values("sequence_number")
    assert ep0.iloc[0]["next_state_features"] == {0: 0.0, 1: 1.0}
    assert ep0.iloc[0]["next_action"] == "1"
    assert ep0.iloc[0]["time_diff"] == 2
    assert list(ep0["sequence_number_ordinal"]) == [1, 2, 3, 4]
    assert list(ep0["time_since_first"]) == [0, 2, 4, 6]
    last = ep0.iloc[-1]
    assert last["not_terminal"] == 0
    assert last["next_state_features"] == {}
    assert last["possible_next_actions"] == []


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_multi_step_timeline_matches_jax(shuffle):
    df = _toy_logged_df()
    out = timeline.multi_step_timeline_transform(df, multi_steps=2, shuffle=shuffle)
    pd.testing.assert_frame_equal(
        out, jax_timeline.multi_step_timeline_transform(df, multi_steps=2, shuffle=shuffle))
    pd.testing.assert_frame_equal(out, timeline.timeline_transform(df, multi_steps=2,
                                                                   shuffle=shuffle))
    ep0 = out[out.mdp_id == "0"].sort_values("sequence_number")
    first = ep0.iloc[0]
    assert len(first["next_state_features"]) == 2
    assert first["reward"] == [1.0, 1.0]
    assert first["not_terminal"] == 1
    penult = ep0.iloc[-2]
    assert len(penult["next_state_features"]) == 1
    assert penult["not_terminal"] == 0


REWARD_CASES = {
    "metric_values": (dict(metric_reward_values={"ctr": 10.0, "watch": 1.0}), [7.0, 1.0, 0.0]),
    "custom_expression": (dict(custom_reward_expression="reward * 2 + metrics_ctr"),
                          [2.5, 4.1, 6.0]),
    "metrics_then_expression": (dict(metric_reward_values={"ctr": 1.0},
                                     custom_reward_expression="reward * 10"), [5.0, 1.0, 0.0]),
    "none": (None, [1.0, 2.0, 3.0]),
}


@pytest.mark.parametrize("case", list(REWARD_CASES))
def test_reward_options_match_jax(case):
    kwargs, want = REWARD_CASES[case]
    df = pd.DataFrame({"reward": [1.0, 2.0, 3.0],
                       "metrics": [{"ctr": 0.5, "watch": 2.0}, {"ctr": 0.1}, {}]})
    ours = reward_options.apply_reward_options(
        df, None if kwargs is None else reward_options.RewardOptions(**kwargs))
    theirs = jax_reward_options.apply_reward_options(
        df, None if kwargs is None else jax_reward_options.RewardOptions(**kwargs))
    pd.testing.assert_frame_equal(ours, theirs)
    np.testing.assert_allclose(ours["reward"], want, rtol=1e-6)


def test_reward_multi_step_fold_matches_jax():
    ms = pd.DataFrame({"reward": [[1.0, 1.0, 1.0], [2.0], 3.0]})
    out = reward_options.calc_reward_multi_steps(ms, gamma=0.5)
    pd.testing.assert_frame_equal(out, jax_reward_options.calc_reward_multi_steps(ms, gamma=0.5))
    np.testing.assert_allclose(out["reward"], [1 + 0.5 + 0.25, 2.0, 3.0])


def _episodes_df():
    rng = np.random.default_rng(0)
    rows = []
    for mdp in range(40):
        n = int(rng.integers(2, 12))
        for t in range(n):
            rows.append({
                "ds": "2026-01-01", "mdp_id": f"m{mdp}", "sequence_number": t * 2,
                "state_features": {0: float(t), 1: float(mdp)},
                "action": str(int(rng.integers(2))), "action_probability": 0.5,
                "reward": float(rng.normal()), "possible_actions": ["0", "1"],
            })
    return pd.DataFrame(rows)


@pytest.mark.parametrize("percentile", [1.0, 0.7])
def test_partitioned_timeline_matches_jax_and_single_shard(percentile):
    df = _episodes_df()
    multi = timeline.partitioned_timeline_transform(
        df, num_partitions=4, percentile=percentile, shuffle=True, seed=5)
    pd.testing.assert_frame_equal(multi, jax_timeline.partitioned_timeline_transform(
        df, num_partitions=4, percentile=percentile, shuffle=True, seed=5))
    single = timeline.timeline_transform(df, percentile=percentile, shuffle=False)
    key = ["mdp_id", "sequence_number"]
    single = single.sort_values(key).reset_index(drop=True)
    multi = multi.sort_values(key).reset_index(drop=True)
    assert len(single) == len(multi)
    for col in ("next_action", "time_diff", "sequence_number_ordinal",
                "time_since_first", "not_terminal"):
        assert list(single[col]) == list(multi[col]), col
    assert list(single["next_state_features"]) == list(multi["next_state_features"])
