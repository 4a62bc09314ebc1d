"""The port's lane game days on the CPU, beside the JAX package's.

Warp runs of the catalog's scenarios that drive a lane beside the engine:
campaign_explain and campaign_explain_paged (the slotserve explanation
lane, contiguous and paged, over a tiny seeded language model) and
drift_shift (the closed learning loop: the labels oracle on the feedback
topic, the learn lane's warm-started refresh, shadow scoring and the
promotion). Each asserts what the JAX package's own test of it asserts,
and the gates whose verdict does not hang on timing read the same as the
JAX run's on the same seed and scale. The language models are seeded
differently in the two packages, so reply text is not compared; drift_shift
runs the JAX xgb demo pipeline's trees carried into the port.
"""

import json

import pytest

from fraud_detection_tpu.scenarios import gameday as Jgd

from torch_parity import (gameday_pipelines, gameday_twins, port_featurizer,
                          port_model, warmed)


@pytest.fixture(scope="module")
def pipelines():
    return gameday_pipelines()


@pytest.fixture(scope="module")
def xgb_pipelines():
    """The JAX game day's own xgb pipeline and the port's twin of its
    trees."""
    from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

    jp = Jgd._default_pipeline(128, model="xgb")
    tp = ServingPipeline(port_featurizer(jp.featurizer), port_model(jp.model),
                         batch_size=128, device="cpu")
    return warmed(jp), warmed(tp)


@pytest.mark.parametrize("name,seed,scale", [("campaign_explain", 5, 0.25),
                                             ("campaign_explain_paged", 5,
                                              0.25)])
def test_slot_lane_game_days_cover_every_flagged_row(pipelines, name, seed,
                                                     scale):
    _, result = gameday_twins(name, seed, scale, pipelines)
    assert result.ok, result.report.table()
    gates = {v.name: v for v in result.report.verdicts}
    assert gates["explain_coverage"].observed == 1.0
    assert gates["slot_accounting_exact"].ok
    ev = result.evidence
    ann, ex = ev["annotations"], ev["explain"]
    assert ann["submitted"] == ann["annotated"] + ann["dropped"]
    assert ann["drop_records"] == ann["dropped"]
    assert ex["admitted"] == ex["completed"] + ex["dropped"]
    if name.endswith("paged"):
        assert gates["prefix_shared"].ok and gates["paged_pool_capped"].ok
        assert gates["hbm_saved"].ok and ex["kv_pages"] == 37
        assert ex["prefix_hits"] == ex["admitted"]
        assert ex["cow_copies"] == ex["admitted"]



def test_drift_shift_closes_the_loop(xgb_pipelines):
    """Seeded mid-run drift -> delayed labels join the learn window -> the
    refresh publishes -> shadow-scores -> auto-promotes within bounded
    virtual seconds, zero-loss/zero-dup through the swap, exact join
    accounting, every transition audited."""
    jres, result = gameday_twins("drift_shift", 11, 0.3, xgb_pipelines)
    assert result.ok, result.table()
    ev = result.evidence
    learn = ev["learn"]
    assert learn["published"] >= 1 and learn["promoted"] >= 1
    w = learn["window"]
    assert w["accounting_exact"] is True
    assert (w["joined"] + w["expired"] + w["missed"] + w["pending_labels"]
            == w["labels_seen"])
    assert ev["swaps"] >= 1
    assert ev["learn_promotion_latency_s"] is not None
    assert ev["learn_promotion_latency_s"] <= 60.0
    assert ev["lifecycle"]["audit_ok"] is True
    assert learn["primary_window_error_rate"] >= 0.08
    assert learn["candidate_window_error_rate"] <= 0.1
    assert any(i["rule"] == "shadow_disagreement_burn"
               for i in ev["alerts"]["incidents"])
    # the labels oracle saw every row of the timeline, in both packages
    assert ev["labels"] == jres.evidence["labels"]
    assert ev["labels"]["fed"] == ev["planned"]
    assert [e["event"] for e in ev["lifecycle"]["events"]] == [
        e["event"] for e in jres.evidence["lifecycle"]["events"]]
    json.dumps(result.as_dict())
