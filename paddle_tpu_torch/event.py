"""Trainer event stream (parity: python/paddle/v2/event.py)."""


class WithMetric:
    def __init__(self, evaluator_result):
        self.metrics = evaluator_result or {}


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator_result=None, gm=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id
        self.gm = gm


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator_result=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost


class EndForwardBackward:
    def __init__(self, pass_id, batch_id, gm=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.gm = gm


class TestResult(WithMetric):
    def __init__(self, pass_id, cost, evaluator_result=None):
        super().__init__(evaluator_result)
        self.pass_id = pass_id
        self.cost = cost
