"""Responses API handler with the agentic MCP tool loop.

Reference: ``src/routers/openai/mcp/tool_loop.rs:41-50`` + responses store
(SURVEY.md §3.4): iterate chat executions; parsed tool calls resolvable in an
MCP server run server-side and their outputs feed the next iteration;
unresolvable (client-executed) function calls are surfaced in the response
output.  Conversation history loads from a conversation id or the
previous_response_id chain; completed responses persist via ResponseStorage.

MCP depth (reference ``crates/mcp``): per-tenant server inventory,
TTL-evicted sessions caching the tool catalog per request chain,
``mcp_list_tools`` output items (suppressed for labels already listed
earlier in the chain), and the APPROVAL flow — a call gated by policy or a
request-level ``require_approval`` pauses the loop with an
``mcp_approval_request`` item; the client resumes with an
``mcp_approval_response`` input item and the gateway executes (or refuses)
the parked call, stateless across instances (pending approvals rebuild
from the stored response chain).

The port's copy of ``smg_tpu/gateway/responses.py``, unchanged but for its
imports.
"""

from __future__ import annotations

import json

from smg_tpu_torch.gateway.router import RouteError, Router
from smg_tpu_torch.mcp import (
    ApprovalManager,
    McpError,
    McpInventory,
    McpRegistry,
    SessionManager,
    ToolDenied,
)
from smg_tpu_torch.protocols.openai import ChatCompletionRequest, ChatMessage, FunctionDef, Tool
from smg_tpu_torch.protocols.responses import (
    ResponseFunctionCallItem,
    ResponseMessageItem,
    ResponseOutputText,
    ResponsesRequest,
    ResponsesResponse,
    ResponseUsage,
)
from smg_tpu_torch.storage import ConversationItem, MemoryStorage, StoredResponse
from smg_tpu_torch.utils import get_logger

logger = get_logger("gateway.responses")

DEFAULT_MAX_TOOL_ITERATIONS = 10


class ResponsesHandler:
    def __init__(self, router: Router, storage=None, mcp: McpRegistry | None = None,
                 inventory: McpInventory | None = None,
                 approvals: ApprovalManager | None = None,
                 sessions: SessionManager | None = None):
        self.router = router
        self.storage = storage or MemoryStorage()
        self.mcp = mcp or McpRegistry()
        self.inventory = inventory  # tenant-scoped server catalog (optional)
        self.approvals = approvals or ApprovalManager()
        self.sessions = sessions or SessionManager()

    # ---- history assembly ----

    async def _load_history(self, req: ResponsesRequest):
        """One storage round-trip for everything create() needs: the
        response chain (previous_response_id mode), the conversation items,
        and a flat list of historical output/input item dicts (approval
        rebuild + mcp_list_tools suppression read these)."""
        chain = []
        conv_items = []
        if req.conversation:
            conv_items = await self.storage.list_items(req.conversation)
        elif req.previous_response_id:
            chain = await self.storage.response_chain(req.previous_response_id)
            if not chain:
                raise RouteError(404, f"response {req.previous_response_id} not found")
        flat: list[dict] = []
        for resp in chain:
            flat.extend(resp.output)
        for it in conv_items:
            if isinstance(it.content, dict):
                flat.append(it.content)
        return chain, conv_items, flat

    def _build_messages(self, req: ResponsesRequest, chain, conv_items) -> list[ChatMessage]:
        messages: list[ChatMessage] = []
        if req.instructions:
            messages.append(ChatMessage(role="system", content=req.instructions))

        if req.conversation:
            for it in conv_items:
                messages.extend(self._item_to_messages(it.type, it.role, it.content))
        else:
            for resp in chain:
                for item in resp.input_items:
                    messages.extend(
                        self._item_to_messages(
                            item.get("type", "message"), item.get("role"), item
                        )
                    )
                for item in resp.output:
                    messages.extend(
                        self._item_to_messages(
                            item.get("type", "message"), item.get("role", "assistant"), item
                        )
                    )

        # current input
        if isinstance(req.input, str):
            messages.append(ChatMessage(role="user", content=req.input))
        else:
            for item in req.input:
                messages.extend(
                    self._item_to_messages(
                        item.get("type", "message"), item.get("role"), item
                    )
                )
        return messages

    def _item_to_messages(self, item_type: str, role, content) -> list[ChatMessage]:
        if item_type == "message":
            if isinstance(content, dict):
                c = content.get("content")
                if isinstance(c, list):
                    text = "".join(
                        p.get("text", "") for p in c
                        if p.get("type") in ("input_text", "output_text", "text")
                    )
                else:
                    text = c or ""
                return [ChatMessage(role=content.get("role") or role or "user", content=text)]
            return [ChatMessage(role=role or "user", content=str(content))]
        if item_type == "function_call":
            name = content.get("name", "") if isinstance(content, dict) else ""
            args = content.get("arguments", "{}") if isinstance(content, dict) else "{}"
            return [
                ChatMessage(
                    role="assistant", content=None,
                    tool_calls=[{
                        "id": content.get("call_id", "call_0"),
                        "type": "function",
                        "function": {"name": name, "arguments": args},
                    }],
                )
            ]
        if item_type == "mcp_call":
            # executed (or refused) server-side MCP call from an earlier
            # turn: replay as assistant tool_call + tool result so the
            # model keeps the context
            if not isinstance(content, dict):
                return []
            call_id = content.get("approval_request_id") or content.get("id") or "mcp_call"
            msgs = [ChatMessage(
                role="assistant", content=None,
                tool_calls=[{
                    "id": call_id, "type": "function",
                    "function": {"name": content.get("name", ""),
                                 "arguments": content.get("arguments", "{}")},
                }],
            )]
            result = content.get("output")
            if result is None:
                result = f"tool error: {content.get('error') or 'unavailable'}"
            msgs.append(ChatMessage(role="tool", content=result,
                                    tool_call_id=call_id))
            return msgs
        if item_type == "function_call_output":
            return [
                ChatMessage(
                    role="tool",
                    content=content.get("output", "") if isinstance(content, dict) else str(content),
                    tool_call_id=content.get("call_id") if isinstance(content, dict) else None,
                )
            ]
        return []

    def _assemble_tools(
        self, req: ResponsesRequest, tenant: str | None = None
    ) -> tuple[list[Tool], McpRegistry, dict, list]:
        """Function tools for the model + an MCP registry for server-side
        execution (gateway-level servers — tenant-filtered through the
        inventory when one is configured — plus request-level mcp tools)
        + per-server-label ``require_approval`` modes + the request-scoped
        server objects (the session owns and closes those)."""
        fn_tools: list[Tool] = []
        req_servers = []
        approval_modes: dict[str, object] = {}
        gateway_labels = set(
            self.inventory.servers if self.inventory is not None
            else self.mcp.servers
        )
        for t in req.tools or []:
            if t.get("type") == "function":
                f = t.get("function", t)
                fn_tools.append(
                    Tool(function=FunctionDef(
                        name=f.get("name", ""),
                        description=f.get("description"),
                        parameters=f.get("parameters"),
                    ))
                )
            elif t.get("type") == "mcp":
                label = t.get("server_label") or t.get("server_url") or ""
                url = t.get("server_url")
                # a url spins up a request-scoped server; a bare label
                # references a gateway-configured server (either way the
                # entry may carry a require_approval mode)
                if url and not url.startswith("local://"):
                    if label in gateway_labels:
                        # a request-level server shadowing a configured
                        # label would inherit its trust/approval policy
                        # while routing traffic to an arbitrary URL
                        raise RouteError(
                            400,
                            f"mcp server_label {label!r} collides with a "
                            "gateway-configured server",
                        )
                    from smg_tpu_torch.mcp import HttpMcpServer

                    req_servers.append(
                        HttpMcpServer(name=label, url=url,
                                      headers=t.get("headers"))
                    )
                if label and t.get("require_approval") is not None:
                    approval_modes[label] = t["require_approval"]
        if self.inventory is not None:
            mcp = self.inventory.registry_for(tenant, extra=req_servers)
        elif req_servers:
            mcp = McpRegistry()
            for name in self.mcp.servers:
                mcp.add(self.mcp._servers[name])
            for s in req_servers:
                mcp.add(s)
        else:
            mcp = self.mcp
        return fn_tools, mcp, approval_modes, req_servers

    @staticmethod
    def _force_approval(mode, tool_name: str) -> bool:
        """Request-level ``require_approval``: "always" | "never" |
        {"always": {"tool_names": [...]}, "never": {"tool_names": [...]}}.
        OpenAI semantics: the dict form defaults to REQUIRING approval —
        only tools in a never-list run unprompted."""
        if mode == "always":
            return True
        if isinstance(mode, dict):
            never = (mode.get("never") or {}).get("tool_names") or []
            always = (mode.get("always") or {}).get("tool_names") or []
            if tool_name in never:
                return False
            if tool_name in always:
                return True
            return True  # dict form: approval required unless never-listed
        return False

    @staticmethod
    def _find_approval_request(history_items: list[dict], key: str) -> dict | None:
        """Rebuild a parked approval from stored history (stateless resume:
        a different gateway instance can pick the decision up)."""
        for item in history_items:
            if item.get("type") == "mcp_approval_request" and item.get("id") == key:
                return item
        return None

    # ---- the loop ----

    async def create(self, req: ResponsesRequest, request_id: str | None = None,
                     tenant: str | None = None) -> ResponsesResponse:
        chain, conv_items, history_items = await self._load_history(req)
        messages = self._build_messages(req, chain, conv_items)
        fn_tools, mcp, approval_modes, req_servers = self._assemble_tools(req, tenant)
        # session key: the conversation id, or the chain ROOT (stable across
        # every turn of a previous_response_id chain)
        session_key = req.conversation or (chain[0].id if chain else None)
        session = await self.sessions.get_or_create(
            session_key, mcp, tenant=tenant, owned=req_servers
        )
        mcp_tools = await session.tools()
        # collisions (same tool on several servers) are advertised to the
        # model under their qualified server.tool names so every variant
        # stays callable; unique tools keep their bare names
        name_count: dict[str, int] = {}
        for t in mcp_tools:
            name_count[t.name] = name_count.get(t.name, 0) + 1
        mcp_names: set = set()
        server_of: dict[str, str] = {}
        advertised: list[tuple] = []  # (advertised_name, ToolInfo)
        for t in mcp_tools:
            name = t.name if name_count[t.name] == 1 else f"{t.server}.{t.name}"
            mcp_names.add(name)
            server_of[name] = t.server
            advertised.append((name, t))
        all_tools = fn_tools + [
            Tool(function=FunctionDef(
                name=name, description=t.description, parameters=t.input_schema
            ))
            for name, t in advertised
        ]

        output_items: list[dict] = []
        usage = ResponseUsage()
        max_iters = req.max_tool_calls or DEFAULT_MAX_TOOL_ITERATIONS
        status = "completed"

        # mcp_list_tools items, one per server label not already listed
        # earlier in the chain / conversation
        # (tool_loop.rs existing_mcp_list_tools_labels)
        if mcp_tools:
            listed: set[str] = set()
            for item in history_items:
                if item.get("type") == "mcp_list_tools":
                    listed.add(item.get("server_label", ""))
            by_server: dict[str, list] = {}
            for t in mcp_tools:
                by_server.setdefault(t.server, []).append({
                    "name": t.name,
                    "description": t.description,
                    "input_schema": t.input_schema,
                })
            for label in sorted(set(by_server) - listed):
                output_items.append({
                    "type": "mcp_list_tools",
                    "server_label": label,
                    "tools": by_server[label],
                })

        # consume mcp_approval_response input items: run (or refuse) the
        # parked calls BEFORE the model continues
        paused = False
        for ar in (req.input if isinstance(req.input, list) else []):
            if ar.get("type") != "mcp_approval_response":
                continue
            key = ar.get("approval_request_id") or ""
            approve = bool(ar.get("approve"))
            # ownership: the key must appear in THIS caller's own chain /
            # conversation history — a pending entry in the shared manager
            # is not proof the caller issued it (cross-chain/tenant
            # approval forgery otherwise)
            info = self._find_approval_request(history_items, key)
            if info is None:
                raise RouteError(404, f"approval request {key!r} not found")
            if not self.approvals.has_pending(key):
                self.approvals.restore(key, info.get("server_label", ""),
                                       info.get("name", ""),
                                       info.get("arguments", "{}"))
            pending = self.approvals.decide(key, approve,
                                            reason=ar.get("reason") or "")
            messages.append(ChatMessage(
                role="assistant", content=None,
                tool_calls=[{"id": key, "type": "function", "function": {
                    "name": pending.tool, "arguments": pending.arguments}}],
            ))
            if approve:
                try:
                    args = json.loads(pending.arguments or "{}")
                except json.JSONDecodeError:
                    args = {}
                try:
                    result = await session.call_tool(pending.tool, args)
                    error = None
                except McpError as e:
                    result, error = None, f"[{e.code}] {e}"
                except Exception as e:
                    result, error = None, str(e)
                output_items.append({
                    "type": "mcp_call", "id": f"mcp_{key}",
                    "approval_request_id": key,
                    "server_label": pending.server, "name": pending.tool,
                    "arguments": pending.arguments,
                    "output": result, "error": error,
                })
                messages.append(ChatMessage(
                    role="tool", content=result if error is None else f"tool error: {error}",
                    tool_call_id=key,
                ))
            else:
                output_items.append({
                    "type": "mcp_call", "id": f"mcp_{key}",
                    "approval_request_id": key,
                    "server_label": pending.server, "name": pending.tool,
                    "arguments": pending.arguments,
                    "output": None, "error": "approval denied by user",
                })
                messages.append(ChatMessage(
                    role="tool", content="tool call denied by the user",
                    tool_call_id=key,
                ))

        for iteration in range(max_iters):
            if paused:
                break
            chat_req = ChatCompletionRequest(
                model=req.model,
                messages=messages,
                tools=all_tools or None,
                temperature=req.temperature,
                top_p=req.top_p,
                max_tokens=req.max_output_tokens,
            )
            resp = await self.router.chat(chat_req, request_id=f"{request_id or 'resp'}-{iteration}")
            choice = resp.choices[0]
            usage.input_tokens += resp.usage.prompt_tokens
            usage.output_tokens += resp.usage.completion_tokens

            if getattr(choice.message, "reasoning_content", None):
                # harmony analysis channel (and any reasoning-parser model)
                # surfaces as a reasoning output item (Responses API shape)
                output_items.append({
                    "type": "reasoning",
                    "summary": [],
                    "content": [{
                        "type": "reasoning_text",
                        "text": choice.message.reasoning_content,
                    }],
                })
            if choice.message.content:
                output_items.append(
                    ResponseMessageItem(
                        content=[ResponseOutputText(text=choice.message.content)]
                    ).model_dump()
                )
            calls = choice.message.tool_calls or []
            if not calls:
                break

            # split server-side (MCP) vs client-executed calls
            client_calls = []
            assistant_msg = ChatMessage(role="assistant", content=choice.message.content,
                                        tool_calls=calls)
            messages.append(assistant_msg)
            for tc in calls:
                fc_item = ResponseFunctionCallItem(
                    call_id=tc.id or f"call_{iteration}",
                    name=tc.function.name or "",
                    arguments=tc.function.arguments or "{}",
                )
                if tc.function.name in mcp_names:
                    name = tc.function.name
                    server = server_of.get(name, "")
                    # approval gate: policy + request-level require_approval.
                    # A parked call pauses the loop with an
                    # mcp_approval_request item the client must answer.
                    try:
                        pending = self.approvals.check(
                            server, name, tc.function.arguments or "{}",
                            request_id=request_id or "",
                            force_approval=self._force_approval(
                                approval_modes.get(server), name),
                        )
                    except ToolDenied as e:
                        output_items.append(fc_item.model_dump())
                        output_items.append({
                            "type": "function_call_output",
                            "call_id": fc_item.call_id,
                            "output": f"tool error: [{e.code}] {e}",
                        })
                        messages.append(ChatMessage(
                            role="tool", content=f"tool error: [{e.code}] {e}",
                            tool_call_id=tc.id,
                        ))
                        continue
                    if pending is not None:
                        # park this call; keep examining the SIBLING calls
                        # of the same assistant turn so none are dropped —
                        # allowed ones still execute, further parks emit
                        # their own approval items
                        output_items.append({
                            "id": pending.key,
                            "type": "mcp_approval_request",
                            "server_label": server,
                            "name": name,
                            "arguments": tc.function.arguments or "{}",
                        })
                        messages.append(ChatMessage(
                            role="tool",
                            content="tool call awaiting user approval",
                            tool_call_id=tc.id,
                        ))
                        paused = True
                        continue
                    output_items.append(fc_item.model_dump())
                    try:
                        args = json.loads(tc.function.arguments or "{}")
                    except json.JSONDecodeError:
                        args = {}
                    try:
                        result = await session.call_tool(name, args)
                    except McpError as e:
                        result = f"tool error: [{e.code}] {e}"
                    except Exception as e:
                        result = f"tool error: {e}"
                    output_items.append(
                        {
                            "type": "function_call_output",
                            "call_id": fc_item.call_id,
                            "output": result,
                        }
                    )
                    messages.append(
                        ChatMessage(role="tool", content=result, tool_call_id=tc.id)
                    )
                else:
                    output_items.append(fc_item.model_dump())
                    client_calls.append(tc)
            if paused or client_calls:
                # client must decide / execute: stop the loop and return
                status = "completed"
                break
        else:
            status = "incomplete"

        usage.total_tokens = usage.input_tokens + usage.output_tokens
        response = ResponsesResponse(
            model=req.model or "default",
            status=status,
            output=output_items,
            previous_response_id=req.previous_response_id,
            conversation={"id": req.conversation} if req.conversation else None,
            usage=usage,
            metadata=req.metadata or {},
        )

        if req.store:
            input_items = (
                [{"type": "message", "role": "user", "content": req.input}]
                if isinstance(req.input, str)
                else list(req.input)
            )
            await self.storage.store_response(
                StoredResponse(
                    id=response.id,
                    previous_response_id=req.previous_response_id,
                    conversation_id=req.conversation,
                    status=status,
                    model=response.model,
                    output=output_items,
                    input_items=input_items,
                    usage=usage.model_dump(),
                    metadata=req.metadata or {},
                )
            )
        if req.conversation:
            items = []
            if isinstance(req.input, str):
                items.append(ConversationItem(
                    type="message", role="user",
                    content={"role": "user", "content": req.input},
                ))
            else:
                for it in req.input:
                    items.append(ConversationItem(
                        type=it.get("type", "message"), role=it.get("role"), content=it
                    ))
            for it in output_items:
                items.append(ConversationItem(
                    type=it.get("type", "message"), role=it.get("role", "assistant"),
                    content=it,
                ))
            await self.storage.add_items(req.conversation, items)
        return response

    async def create_stream(self, req: ResponsesRequest, request_id: str | None = None,
                            tenant: str | None = None):
        """Responses streaming events (subset): response.created,
        response.output_item.added, response.output_text.delta,
        response.output_item.done, response.completed."""
        seq = 0

        def ev(name: str, payload: dict):
            nonlocal seq
            seq += 1
            return name, {"type": name, "sequence_number": seq, **payload}

        # run the loop non-streaming for tool iterations, then re-emit
        response = await self.create(req, request_id=request_id, tenant=tenant)
        yield ev("response.created", {"response": {"id": response.id, "status": "in_progress"}})
        for idx, item in enumerate(response.output):
            yield ev("response.output_item.added", {"output_index": idx, "item": item})
            if item.get("type") == "message":
                for c in item.get("content", []):
                    if c.get("type") == "output_text" and c.get("text"):
                        yield ev(
                            "response.output_text.delta",
                            {"output_index": idx, "delta": c["text"]},
                        )
            elif item.get("type") == "reasoning":
                for c in item.get("content", []):
                    if c.get("type") == "reasoning_text" and c.get("text"):
                        yield ev(
                            "response.reasoning_text.delta",
                            {"output_index": idx, "delta": c["text"]},
                        )
            yield ev("response.output_item.done", {"output_index": idx, "item": item})
        yield ev("response.completed", {"response": response.model_dump()})
