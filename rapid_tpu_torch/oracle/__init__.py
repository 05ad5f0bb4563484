"""Host mirrors of the protocol that the churn planner replays.

Own copies of the reference oracle's ``MembershipView`` (the K rings,
observers, subjects, join safety and configuration ids),
``MultiNodeCutDetector`` and the cluster rng that draws a joiner's node
ids; ``engine.churn.plan_churn`` drives them tick by tick.
"""
